"""horovod_tpu_torch T5 == horovod_tpu T5: relative position buckets, the
logits, the encoder alone, ``seq2seq_loss`` and every gradient.

``relative_position_bucket`` truncates an fp32 log ratio to an integer, so
the port must reproduce every bucket exactly: every offset in [-1024, 1024],
bidirectional and causal, at T5-small's (32 buckets, 128) and the tiny (8,
32). A tiny fp32 T5 is initialised by the JAX package and carried to the
port with ``t5_params_from_jax``; the same numpy sources (one padded row,
one row all padding) and targets (some padded) go through both, within the
fp32 tolerances of the other port tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.t5 import T5 as JT5
from horovod_tpu.models.t5 import T5Config as JConfig
from horovod_tpu.models.t5 import relative_position_bucket as jbucket
from horovod_tpu.models.t5 import seq2seq_loss as jseq2seq_loss
from horovod_tpu.models.t5 import shift_right as jshift_right

from horovod_tpu_torch.models import get_model
from horovod_tpu_torch.models.convert import t5_params_from_jax
from horovod_tpu_torch.models.t5 import (T5, T5Config,
                                         relative_position_bucket,
                                         seq2seq_loss, shift_right)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-6)
B, TS, TT = 4, 14, 9


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 32)])
def test_relative_position_bucket_exact_for_every_offset(
        buckets, max_distance, bidirectional):
    rel = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jbucket(jnp.asarray(rel), bidirectional=bidirectional,
                              num_buckets=buckets,
                              max_distance=max_distance))
    got = relative_position_bucket(torch.tensor(rel),
                                   bidirectional=bidirectional,
                                   num_buckets=buckets,
                                   max_distance=max_distance)
    np.testing.assert_array_equal(got.numpy(), want)


def _batch(seed=0):
    g = np.random.default_rng(seed)
    src = g.integers(1, 256, (B, TS)).astype(np.int32)
    src[1, -5:] = 0                    # a padded source row
    src[2, :] = 0                      # a source row all padding
    labels = g.integers(1, 256, (B, TT)).astype(np.int32)
    labels[3, -4:] = 0                 # padded targets
    return src, labels


@pytest.fixture(scope="module")
def jax_params():
    src, labels = _batch()
    jm = JT5(JConfig.tiny(dtype=jnp.float32))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(src),
                              jshift_right(jnp.asarray(labels), 0))
    return jax.tree_util.tree_map(np.asarray, params["params"])


def _port(params):
    m = T5(T5Config.tiny(dtype=torch.float32),
           torch.Generator().manual_seed(1))
    m.load_state_dict(t5_params_from_jax(params), strict=True)
    return m


def test_config_fields_and_state_dict_match_reference(jax_params):
    jf = [f.name for f in dataclasses.fields(JConfig)]
    assert jf == [f.name for f in dataclasses.fields(T5Config)]
    for name in jf:
        if name != "dtype":
            for preset in ("small", "tiny"):
                assert getattr(getattr(JConfig, preset)(), name) == \
                    getattr(getattr(T5Config, preset)(), name), name
    sd = t5_params_from_jax(jax_params)
    assert set(sd) == set(T5(T5Config.tiny()).state_dict())
    np.testing.assert_array_equal(
        sd["dec.1.cross_attn.k.weight"].numpy(),
        jax_params["dec1"]["cross_attn"]["k"]["kernel"].T)
    np.testing.assert_array_equal(sd["enc_rel.rel_bias"].numpy(),
                                  jax_params["enc_rel"]["rel_bias"])
    for name in ("t5", "t5_small", "T5-small"):
        with torch.device("meta"):
            m = get_model(name)
        assert isinstance(m, T5) and m.cfg.num_encoder_layers == 6
        assert m.cfg.d_model == 512 and m.cfg.vocab_size == 32128


def test_logits_and_encoder_match(jax_params):
    src, labels = _batch()
    jm = JT5(JConfig.tiny(dtype=jnp.float32))
    js, jd = jnp.asarray(src), jshift_right(jnp.asarray(labels), 0)
    jlogits = jax.jit(jm.apply)({"params": jax_params}, js, jd)
    jenc = jax.jit(jm.apply)({"params": jax_params}, js)
    m = _port(jax_params)
    ts = torch.tensor(src)
    dec_in = shift_right(torch.tensor(labels), 0)
    np.testing.assert_array_equal(dec_in.numpy(), np.asarray(jd))
    logits = m(ts, dec_in)
    assert logits.shape == (B, TT, 256)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    enc = m(ts)
    assert enc.shape == (B, TS, 64)
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(jenc),
                               **LOGIT_TOL)
    assert torch.isfinite(enc[2]).all()


def test_seq2seq_loss_and_every_gradient_match(jax_params):
    src, labels = _batch(1)
    src[2, :] = 0
    jm = JT5(JConfig.tiny(dtype=jnp.float32))
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jseq2seq_loss(
        jm, p, jnp.asarray(src), jnp.asarray(labels))))(
            jax.tree_util.tree_map(jnp.asarray, jax_params))
    want = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    m = _port(jax_params)
    loss = seq2seq_loss(m, torch.tensor(src), torch.tensor(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    got = {n: p.grad for n, p in m.named_parameters()}
    assert set(got) == set(want)
    for n in sorted(want):
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   err_msg=n, **GRAD_TOL)
