"""horovod_tpu_torch MnistCNN == horovod_tpu's, on the CPU.

The JAX package initialises the model; ``mnist_params_from_jax`` carries
the parameters over. In eval mode (no dropout) the same numpy images give
the same logits, loss and gradients, fp32, at ``LOGIT_TOL`` / ``GRAD_TOL``
as tests/test_torch_port_gpt2.py states them; this holds only if the port
flattens the pooled maps in flax's (h, w, c) order. Dropout draws from a
``torch.Generator`` whose stream cannot match JAX's, so it is checked on
the port alone: the keep rate and the 1 / (1 - rate) scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.mnist import MnistCNN as JMnist

from horovod_tpu_torch.models.convert import mnist_params_from_jax
from horovod_tpu_torch.models.mnist import MnistCNN, dropout

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)


def _images(seed=0, n=6):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, 28, 28, 1)).astype(np.float32),
            g.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def jax_params():
    x, _ = _images()
    p = JMnist().init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return jax.tree_util.tree_map(np.asarray, p)


def _port(params):
    m = MnistCNN(generator=torch.Generator().manual_seed(3))
    m.load_state_dict(mnist_params_from_jax(params), strict=True)
    return m.eval()


def _nchw(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


def test_converted_state_dict_loads_strict(jax_params):
    sd = mnist_params_from_jax(jax_params)
    assert set(sd) == set(MnistCNN().state_dict())
    assert sd["dense0.weight"].shape == (128, 12544)
    np.testing.assert_array_equal(
        sd["conv1.weight"].numpy(),
        jax_params["Conv_1"]["kernel"].transpose(3, 2, 0, 1))


def test_eval_logits_loss_and_grads_match(jax_params):
    x, y = _images(1)

    def loss(p):
        logits = JMnist().apply({"params": p}, jnp.asarray(x), train=False)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(y)[:, None], 1)), logits
    (jl, jlogits), jg = jax.value_and_grad(loss, has_aux=True)(jax_params)
    m = _port(jax_params)
    logits = m(_nchw(x))
    pl = F.cross_entropy(logits, torch.tensor(y).long())
    pl.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    want = mnist_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_flatten_order_is_flax_hwc(jax_params):
    """Flattening NCHW in (c, h, w) order would scramble Dense_0's rows:
    the logits then disagree."""
    x, _ = _images(2)
    want = np.asarray(JMnist().apply({"params": jax_params}, jnp.asarray(x),
                                     train=False))
    m = _port(jax_params)
    with torch.no_grad():
        h = F.max_pool2d(F.relu(m.conv1(F.relu(m.conv0(_nchw(x))))), 2, 2)
        chw = m.dense1(F.relu(m.dense0(h.reshape(h.shape[0], -1))))
    assert not np.allclose(chw.numpy(), want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(m(_nchw(x)).detach().numpy(), want,
                               **LOGIT_TOL)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.full((200, 500), 3.0)
    out = dropout(x, rate, torch.Generator().manual_seed(0))
    kept = out != 0
    # 100,000 draws: the keep share is within 0.5 % of 1 - rate (~3.5
    # standard deviations).
    assert abs(kept.float().mean().item() - (1 - rate)) < 5e-3
    assert torch.equal(out[kept], torch.full_like(out[kept],
                                                  3.0 / (1 - rate)))
    again = dropout(x, rate, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_train_mode_drops_and_eval_mode_does_not(jax_params):
    m = _port(jax_params)
    x = _nchw(_images(3)[0])
    g = torch.Generator().manual_seed(1)
    m.train()
    a, b = m(x, g), m(x, g)
    assert not torch.equal(a, b)          # a new mask each call
    m.eval()
    assert torch.equal(m(x, g), m(x))
