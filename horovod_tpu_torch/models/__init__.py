"""Models of the port (MNIST, ResNet, GPT-2, BERT, ViT, Llama) and parameter
conversion from the JAX package's trees.

``get_model(name, **kw)`` builds the ported models by the reference's
names (``horovod_tpu.models.get_model``); any other name raises, pointing
to ``ROADMAP.md``, which lists the reference's models still to be ported.
"""

__all__ = ["get_model", "PORTED"]

PORTED = ("mnist", "resnet18", "resnet50", "gpt2_medium", "bert",
          "bert_large", "vit", "vit_b16", "llama", "llama7b", "llama_small")


def get_model(name: str, **kw):
    """A ported model by name: ``mnist`` (``MnistCNN``), ``resnet18`` /
    ``resnet50`` (``ResNet18`` / ``ResNet50``), ``gpt2_medium``
    (``GPT2`` of ``GPT2Config.medium(**kw)``), ``bert`` / ``bert_large``
    (``Bert`` of ``BertConfig(**kw)`` / ``BertConfig.large(**kw)``), ``vit``
    / ``vit_b16`` (``ViT`` of ``ViTConfig(**kw)`` / ``ViTConfig.b16(**kw)``),
    ``llama`` / ``llama_small`` / ``llama7b`` (``Llama`` of the small or
    7B preset with ``kw`` replacing its fields). A ``generator`` goes to
    the model's constructor, as do the other ``kw`` of ``mnist`` and the
    ResNets."""
    key = name.lower().replace("-", "_")
    gen = {"generator": kw.pop("generator")} if "generator" in kw else {}
    if key == "mnist":
        from horovod_tpu_torch.models.mnist import MnistCNN
        return MnistCNN(**kw, **gen)
    if key in ("resnet18", "resnet50"):
        from horovod_tpu_torch.models import resnet
        return (resnet.ResNet18 if key == "resnet18" else resnet.ResNet50)(
            **kw, **gen)
    if key == "gpt2_medium":
        from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config
        return GPT2(GPT2Config.medium(**kw), **gen)
    if key in ("bert", "bert_large"):
        from horovod_tpu_torch.models.bert import Bert, BertConfig
        return Bert(BertConfig.large(**kw) if key == "bert_large"
                    else BertConfig(**kw), **gen)
    if key in ("vit", "vit_b16", "vit_b/16"):
        from horovod_tpu_torch.models.vit import ViT, ViTConfig
        return ViT(ViTConfig(**kw) if key == "vit" else ViTConfig.b16(**kw),
                   **gen)
    if key in ("llama", "llama_small", "llama7b"):
        from horovod_tpu_torch.models.llama import Llama, LlamaConfig
        return Llama(LlamaConfig.llama7b(**kw) if key == "llama7b"
                     else LlamaConfig.small(**kw), **gen)
    raise ValueError(f"model {name!r} is not ported (ported: "
                     f"{', '.join(PORTED)}); ROADMAP.md section A lists the "
                     "reference's models still to be ported")
