"""horovod_tpu_torch.data.packing == horovod_tpu.data.packing, and a packed
batch through the port's GPT-2 == through the reference's.

Seeded documents (numpy) are packed by both; the rows, tokens and segment
ids must be equal exactly, and both must refuse the same inputs. Then a
packed batch goes through a tiny fp32 GPT-2 of each package (parameters
carried over by ``convert.py``) with packed positions and the packed loss,
within the fp32 tolerances of the other port tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.data import packing as jpacking
from horovod_tpu.models.gpt2 import GPT2 as JGPT2
from horovod_tpu.models.gpt2 import GPT2Config as JConfig
from horovod_tpu.models.gpt2 import loss_fn as jloss_fn
from horovod_tpu.ops.attention import packed_positions as jpacked_positions

from horovod_tpu_torch.data import packing
from horovod_tpu_torch.models.convert import gpt2_params_from_jax
from horovod_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
from horovod_tpu_torch.ops.attention import packed_positions

LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


def _docs(seed, n, row_len):
    g = np.random.default_rng(seed)
    lengths = g.integers(1, row_len + 1, n)
    return [g.integers(1, 256, int(ln)).tolist() for ln in lengths]


@pytest.mark.parametrize("seed,n,row_len", [(0, 20, 32), (1, 57, 64),
                                            (2, 200, 128), (3, 1, 16),
                                            (4, 40, 7)])
def test_pack_documents_equals_reference(seed, n, row_len):
    docs = _docs(seed, n, row_len)
    lengths = [len(d) for d in docs]
    np.testing.assert_array_equal(packing.pack_rows(lengths, row_len),
                                  jpacking.pack_rows(lengths, row_len))
    tok, seg = packing.pack_documents(docs, row_len, pad_id=3)
    jtok, jseg = jpacking.pack_documents(docs, row_len, pad_id=3)
    assert tok.dtype == jtok.dtype == np.int32
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(seg, jseg)


def test_empty_and_refusals_as_reference():
    assert packing.pack_rows([], 8).shape == (0,)
    for fn in (packing.pack_rows, jpacking.pack_rows):
        with pytest.raises(ValueError, match="cannot fit"):
            fn([3, 9], 8)
        with pytest.raises(ValueError, match="negative document length"):
            fn([3, -1], 8)
    docs = _docs(5, 30, 16)
    for fn in (packing.pack_documents, jpacking.pack_documents):
        with pytest.raises(ValueError, match="max_rows=1"):
            fn(docs, 16, max_rows=1)


def test_packed_batch_through_gpt2_matches_reference():
    tok, seg = packing.pack_documents(_docs(6, 12, 32), 32)
    cfg = JConfig.tiny(dtype=jnp.float32, attention="dense")
    jm = JGPT2(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(tok))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    jt, js = jnp.asarray(tok), jnp.asarray(seg)
    jpos = jpacked_positions(js)
    jlogits = jax.jit(lambda p: jm.apply({"params": p}, jt, segment_ids=js,
                                         positions=jpos))(params)
    jl = jloss_fn(jlogits, jt, segment_ids=js)
    m = GPT2(GPT2Config.tiny(dtype=torch.float32, attention="flash"))
    m.load_state_dict(gpt2_params_from_jax(params), strict=True)
    tt, ts = torch.tensor(tok), torch.tensor(seg)
    pos = packed_positions(ts)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    logits = m(tt, segment_ids=ts, positions=pos)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    np.testing.assert_allclose(loss_fn(logits, tt, segment_ids=ts).item(),
                               float(jl), rtol=1e-5)
