"""Models of the port (MNIST, ResNet, GPT-2) and parameter conversion from
the JAX package's trees.

``get_model(name, **kw)`` builds the ported models by the reference's
names (``horovod_tpu.models.get_model``); any other name raises, pointing
to ``ROADMAP.md``, which lists the reference's models still to be ported.
"""

__all__ = ["get_model", "PORTED"]

PORTED = ("mnist", "resnet18", "resnet50", "gpt2_medium")


def get_model(name: str, **kw):
    """A ported model by name: ``mnist`` (``MnistCNN``), ``resnet18`` /
    ``resnet50`` (``ResNet18`` / ``ResNet50``), ``gpt2_medium``
    (``GPT2(GPT2Config.medium(**kw))``). ``kw`` go to the constructor."""
    key = name.lower().replace("-", "_")
    if key == "mnist":
        from horovod_tpu_torch.models.mnist import MnistCNN
        return MnistCNN(**kw)
    if key in ("resnet18", "resnet50"):
        from horovod_tpu_torch.models import resnet
        return (resnet.ResNet18 if key == "resnet18" else resnet.ResNet50)(
            **kw)
    if key == "gpt2_medium":
        from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
        return GPT2(GPT2Config.medium(**kw))
    raise ValueError(f"model {name!r} is not ported (ported: "
                     f"{', '.join(PORTED)}); ROADMAP.md section A lists the "
                     "reference's models still to be ported")
