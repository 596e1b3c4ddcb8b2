"""The port's Seq2SeqEngine (T5 serving on a paged KV cache) against the JAX
package, on the CPU.

The JAX engine's own test's tiny T5 (vocab 64, d 32, 4 heads of 8, 2 + 2
layers, d_ff 48, 8 buckets to 20), relu / tied and gated / untied, with
the port's seeded weights (``utils.params_to_numpy``), the relpos tables
scaled to N(0, 1) so that the bias moves the scores. The engine's greedy
tokens equal JAX's jitted ``T5.greedy_decode`` on the same weights (the
sources padded to SRC_PAD under ``src_valid``, one compiled decode a
variant), through the six cases of tests/test_seq2seq_engine.py; in a
continuous-batching run every step's tokens and logits equal the JAX
engine's step (compiled once, fp32 at rtol 1e-5 / atol 2e-5, BASELINE.md:16).
Sampling: the same seed gives the same tokens, top_k = 1 gives greedy's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.serving import Seq2SeqEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.serving import OutOfPagesError, Seq2SeqEngine
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
CFG = dict(vocab_size=64, d_model=32, d_kv=8, num_heads=4,
           num_encoder_layers=2, num_decoder_layers=2, d_ff=48,
           relpos_buckets=8, relpos_max_distance=20)
VARIANTS = {"relu_tied": dict(gated_act=False, tie_embeddings=True),
            "gated_untied": dict(gated_act=True, tie_embeddings=False)}
# JAX's greedy decode runs on SOLO_B sources padded to SRC_PAD tokens and
# decodes SOLO_STEPS tokens: one compiled function a variant.
SOLO_B, SRC_PAD, SOLO_STEPS = 4, 16, 8
rng = np.random.default_rng(0)


@functools.lru_cache(maxsize=None)
def _pair(variant):
    """(port T5 on the CPU, JAX T5, its params, jitted JAX greedy decode)
    on one set of seeded weights."""
    cfg = dict(CFG, **VARIANTS[variant])
    tree = params_to_numpy(tmodels.T5(tmodels.T5Config(**cfg),
                                      device="cpu").init(
        torch.Generator().manual_seed(1)))
    for name in ("enc_relpos", "dec_relpos"):  # N(0, 1): a bias that bites
        tree[name] = tree[name] * 50.0
    tt5 = params_from_numpy(tree, tmodels.T5Config(**cfg), device="cpu")
    jt5 = jmodels.T5(jmodels.T5Config(**cfg))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    greedy = jax.jit(lambda p, s, v: jt5.greedy_decode(p, s, 0, SOLO_STEPS,
                                                       src_valid=v))
    return tt5, jt5, params, greedy


def _solo(variant, *sources):
    """JAX's greedy tokens [SOLO_STEPS] of each source, alone."""
    _, _, params, greedy = _pair(variant)
    src = np.zeros((SOLO_B, SRC_PAD), np.int32)
    valid = np.zeros((SOLO_B, SRC_PAD), bool)
    valid[:, 0] = True
    for i, s in enumerate(sources):
        src[i, :len(s)] = s
        valid[i, :len(s)] = True
    out = np.asarray(greedy(params, jnp.asarray(src), jnp.asarray(valid)))
    return out[:len(sources)]


def _engine(variant="relu_tied", **kw):
    return Seq2SeqEngine(_pair(variant)[0], **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_matches_greedy_decode(variant):
    src = rng.integers(1, 64, (7,))
    steps = 6
    eng = _engine(variant, max_src_len=16, max_tgt_len=16, total_pages=16,
                  page_size=4, max_seqs=4)
    eng.add_request(0, src)
    toks = [eng.step()[0] for _ in range(steps)]
    np.testing.assert_array_equal(toks, _solo(variant, src)[0, :steps])


def test_continuous_batching_isolated_sequences():
    """A sequence decoding beside others (other source lengths, a join
    mid-stream, an early leave) gives its solo tokens."""
    s1 = rng.integers(1, 64, (9,))
    s2 = rng.integers(1, 64, (4,))
    solo = _solo("relu_tied", s1, s2)[:, :5]
    eng = _engine(max_src_len=16, max_tgt_len=16, total_pages=32,
                  page_size=4, max_seqs=4)
    eng.add_request(0, s1)
    t1 = [eng.step()[0], eng.step()[0]]
    eng.add_request(1, s2)           # joins two steps in
    t2 = []
    for _ in range(3):
        out = eng.step()
        t1.append(out[0])
        t2.append(out[1])
    eng.finish(0)                    # leaves; its pages go home
    t2 += [eng.step()[1], eng.step()[1]]
    np.testing.assert_array_equal(t1, solo[0])
    np.testing.assert_array_equal(t2, solo[1])
    assert eng.live == [1] and len(eng._free) == 32 - 1 - 2   # 5 tokens


def _jax_logits_step(jeng):
    """The JAX engine's device step returning its logits too, compiled
    (eagerly it traces the model op by op): ``_sample`` is shadowed while
    it traces, to hand the logits out."""

    def step(state, params, key):
        seen = []

        def sample(logits, key):
            seen.append(logits)
            return JaxEngine._sample(jeng, logits, key)

        jeng._sample = sample
        try:
            state, tok = jeng._device_step(state, params, key)
        finally:
            del jeng._sample
        return state, tok, seen[0]

    return jax.jit(step)


def test_step_logits_match_jax_engine():
    """Both engines under the same traffic (ragged sources, two joins, a
    leave): each step's tokens equal and its logits within fp32 TOL on
    every live slot; page accounting equal."""
    tt5, jt5, params, _ = _pair("relu_tied")
    kw = dict(max_src_len=16, max_tgt_len=16, total_pages=24, page_size=4,
              max_seqs=4)
    teng = Seq2SeqEngine(tt5, **kw)
    jeng = JaxEngine(jt5, params, **kw)
    jstep = _jax_logits_step(jeng)

    def both_step():
        st = teng._grow_tables(1)
        teng._state, t_tok, t_logits = teng._device_step(st,
                                                         return_logits=True)
        st = jeng._grow_tables(1)
        jeng._state, j_tok, j_logits = jstep(st, params,
                                             jax.random.PRNGKey(0))
        for eng in (teng, jeng):
            for sid in eng._slots:
                eng._host_len[sid] += 1
        active = np.asarray(jeng._state["active"])
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
        np.testing.assert_allclose(t_logits.numpy()[active],
                                   np.asarray(j_logits)[active], **TOL)
        return t_tok.numpy()

    sources = {sid: rng.integers(1, 64, (n,))
               for sid, n in ((0, 9), (1, 4), (2, 16), (3, 1))}
    for sid in (0, 1):
        teng.add_request(sid, sources[sid])
        jeng.add_request(sid, sources[sid])
    toks = [both_step() for _ in range(2)]
    for sid in (2, 3):
        teng.add_request(sid, sources[sid])
        jeng.add_request(sid, sources[sid])
    toks += [both_step() for _ in range(3)]
    teng.finish(0)
    jeng.finish(0)
    toks += [both_step() for _ in range(2)]
    assert teng.live == jeng.live == [1, 2, 3]
    assert teng._free == jeng._free
    assert len(set(np.concatenate(toks).tolist())) > 4   # tokens vary


def test_step_many_matches_stepwise():
    src = rng.integers(1, 64, (5,))
    eng = _engine(max_src_len=8, max_tgt_len=8, total_pages=16, page_size=4,
                  max_seqs=2)
    eng.add_request(7, src)
    out = eng.step_many(6)
    np.testing.assert_array_equal(out[7], _solo("relu_tied", src)[0, :6])
    assert eng.capacity(7) == 2


def test_page_exhaustion_and_reclaim():
    # 4 usable pages (the last is the trash page), page_size 2.
    eng = _engine(max_src_len=8, max_tgt_len=8, total_pages=5, page_size=2,
                  max_seqs=4)
    eng.add_request(0, rng.integers(1, 64, (3,)))
    eng.add_request(1, rng.integers(1, 64, (3,)))
    eng.step_many(4)                 # 2 pages each = 4 of 4 used
    with pytest.raises(OutOfPagesError):
        eng.step()                   # the 5th token needs a 3rd page apiece
    assert eng._free == [] and eng.capacity(0) == 4   # nothing changed
    eng.finish(1)                    # reclaim
    eng.step()                       # now fits
    assert eng.live == [0] and eng.capacity(0) == 3


def test_capacity_limit_is_max_tgt_len():
    eng = _engine(max_src_len=8, max_tgt_len=4, total_pages=16, page_size=2,
                  max_seqs=2)
    eng.add_request(0, rng.integers(1, 64, (3,)))
    eng.step_many(4)
    with pytest.raises(OutOfPagesError, match="max_tgt_len"):
        eng.step()


def test_source_too_long_and_busy_slots_rejected():
    eng = _engine(max_src_len=4, max_tgt_len=8, total_pages=16, page_size=2,
                  max_seqs=2)
    with pytest.raises(ValueError, match="max_src_len"):
        eng.add_request(0, rng.integers(1, 64, (5,)))
    eng.add_request(0, rng.integers(1, 64, (4,)))
    with pytest.raises(ValueError, match="already live"):
        eng.add_request(0, rng.integers(1, 64, (4,)))
    eng.add_request(1, rng.integers(1, 64, (2,)))
    with pytest.raises(RuntimeError, match="slots busy"):
        eng.add_request(2, rng.integers(1, 64, (2,)))


def test_sampled_decode_is_seeded_and_top_k_1_is_greedy():
    src = rng.integers(1, 64, (6,))
    runs = []
    for kw in (dict(temperature=1.5, top_k=20, seed=3),
               dict(temperature=1.5, top_k=20, seed=3),
               dict(temperature=1.0, top_k=1, seed=5)):
        eng = _engine(max_src_len=8, max_tgt_len=8, total_pages=8,
                      page_size=4, max_seqs=2, **kw)
        eng.add_request(0, src)
        runs.append(eng.step_many(8)[0])
    assert runs[0] == runs[1]
    np.testing.assert_array_equal(runs[2], _solo("relu_tied", src)[0])


def test_state_lives_on_the_models_device():
    """An engine over a CPU model keeps every state tensor on the CPU; a
    T5 built without a device names the card."""
    eng = _engine(max_src_len=8, max_tgt_len=8, total_pages=8, page_size=4,
                  max_seqs=2)
    tensors = [t for v in eng._state.values()
               for t in (v if isinstance(v, list) else [v])]
    assert {t.device.type for t in tensors} == {"cpu"}
    assert eng._by_dist.device.type == "cpu"
    cfg = tmodels.T5Config(**CFG)
    if torch.cuda.is_available():
        assert tmodels.T5(cfg).embedding.table.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tmodels.T5(cfg)
