"""The MoE FFN (``nn.MoE``) and MoE GPTs in the port against the JAX package,
on the CPU.

At tiny sizes (d 32, 8 or 16 experts of 16, two or three layers):
``MoE.apply_with_aux(collect_stats=True)`` against JAX's for every router
rule (default k 1 and 2, softmax, softmax_norm, topk_softmax; softmax and
sigmoid scores; the router bias and the select bias; group-limited routing
by max and top2sum; routed scaling), every expert form (mlp relu and gelu,
swiglu, geglu, glu_clamp), each dispatch (no-drop by both of its product
routes, sorted and dense with capacities that drop tokens), shared experts,
fp32 and bf16 inputs: the output, aux, dropped fraction and expert load.
Constructed ties (duplicated router columns, equal group scores) pick JAX's
expert, the lower index. Then an MLA + MoE GPT with ``moe_first_dense=1``
(``apply``, ``loss`` with its aux, the decode steps' logits and
``generate``), the engine with chunked prefill and continuous batching
against JAX's engine (MLA + MoE on latent pages, and a swiglu MoE GPT on
ordinary pages), a capacity-limited MoE GPT through the engine's dense
prefill, JAX's refusals and the weights' round trip (the backward is held
in tests/test_torch_moe_train.py). The weights come from the port's ``init`` (biases and the select
bias drawn afterwards, so that they count); the JAX side runs under
``jax.jit``. fp32 at rtol 1e-5 / atol 2e-5 (BASELINE.md:16); bf16 outputs
within BF16_TOL x max(1, max |JAX's|), the routing (expert load, dropped
fraction) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.nn.moe import MoE as JMoE
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.nn import MoE
from np_modeling_tpu_torch.nn import moe as moe_mod
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
# bf16 experts: JAX's ragged_dot and torch's bf16 products round their
# bf16 results apart by a unit or two in the last place (2 ** -8 relative).
BF16_TOL = 1.6e-2
D = 32
rng = np.random.default_rng(61)

# (id, MoE fields, tokens). Tokens x top_k at most moe.GATHER_MAX take the
# gathered product, more the loop over experts.
CASES = [
    ("mlp_relu_default_k2_dense_drops",
     dict(num_experts=8, hidden_units=16, capacity_factor=0.5), 24),
    ("mlp_gelu_default_k1_dense",
     dict(num_experts=8, hidden_units=16, router_top_k=1,
          activation="gelu", capacity_factor=1.0), 24),
    ("mlp_relu_k2_sorted_drops_select_bias",
     dict(num_experts=16, hidden_units=16, capacity_factor=0.75,
          router_select_bias=True), 40),
    ("swiglu_softmax_k6_nodrop_shared_gathered",
     dict(num_experts=16, hidden_units=16, ffn="swiglu", capacity_factor=None,
          router_top_k=6, router_weights="softmax",
          shared_experts_units=32), 8),
    ("swiglu_softmax_k6_nodrop_shared_loop",
     dict(num_experts=16, hidden_units=16, ffn="swiglu", capacity_factor=None,
          router_top_k=6, router_weights="softmax",
          shared_experts_units=32, routed_scaling=1.5), 40),
    ("geglu_softmax_norm_groups_max_nodrop",
     dict(num_experts=16, hidden_units=16, ffn="geglu", capacity_factor=None,
          router_top_k=3, router_weights="softmax_norm",
          router_groups=(4, 2), shared_experts_units=16), 40),
    ("geglu_sigmoid_top2sum_select_bias_sorted",
     dict(num_experts=16, hidden_units=16, ffn="geglu", capacity_factor=1.0,
          router_top_k=4, router_weights="softmax_norm",
          router_score="sigmoid", router_select_bias=True,
          router_groups=(4, 2), router_group_metric="top2sum",
          routed_scaling=2.5, dispatch_impl="sorted"), 40),
    ("swiglu_sigmoid_softmax_groups_dense",
     dict(num_experts=8, hidden_units=16, ffn="swiglu", capacity_factor=1.25,
          router_top_k=2, router_weights="softmax", router_score="sigmoid",
          router_groups=(2, 1), dispatch_impl="dense"), 24),
    ("glu_clamp_topk_softmax_router_bias_nodrop",
     dict(num_experts=8, hidden_units=16, ffn="glu_clamp",
          capacity_factor=None,
          router_top_k=4, router_weights="topk_softmax", router_bias=True),
     32),
    ("glu_clamp_topk_softmax_sorted_drops",
     dict(num_experts=16, hidden_units=16, ffn="glu_clamp",
          capacity_factor=0.5,
          router_top_k=2, router_weights="topk_softmax", router_bias=True,
          dispatch_impl="sorted"), 40),
]


def _moe(fields, seed=0):
    """The port's MoE from its seeded init, with every 1-D or bias leaf
    drawn N(0, 0.1) (init zeroes them), its JAX twin and JAX's tree."""
    m = MoE(D, **fields, device="cpu").init(
        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.startswith(("b", "router_")):
                p.normal_(0.0, 0.1, generator=g)
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  tree_to_numpy(dict(m.named_parameters())))
    return m, JMoE(**fields), tree


def _jax_moe(jm, tree, x):
    return jax.jit(lambda p, x: jm.apply_with_aux(p, x, collect_stats=True))(
        tree, x)


def _compare(got, want, dtype):
    (out, aux, stats), (jout, jaux, jstats) = got, want
    jout = np.asarray(jout.astype(jnp.float32))
    out = out.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, jout, **TOL)
    else:
        err = np.abs(out - jout).max() / max(1.0, np.abs(jout).max())
        assert err <= BF16_TOL, err
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(float(stats["dropped_fraction"]),
                               float(jstats["dropped_fraction"]), atol=1e-6)
    np.testing.assert_allclose(stats["expert_load"].numpy(),
                               np.asarray(jstats["expert_load"]), atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_apply_with_aux_vs_jax(case, dtype):
    """Output, aux, dropped fraction and expert load against JAX's; a
    capacity case drops tokens."""
    _, fields, t = case
    m, jm, tree = _moe(fields)
    x = rng.standard_normal((2, t // 2, D)).astype(np.float32)
    xt = torch.tensor(x).to(dtype)
    want = _jax_moe(jm, tree, jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    with torch.no_grad():
        got = m.apply_with_aux(xt, collect_stats=True)
    assert got[0].dtype == dtype and got[0].shape == xt.shape
    _compare(got, want, dtype)
    if fields["capacity_factor"] is not None and "drops" in case[0]:
        assert float(got[2]["dropped_fraction"]) > 0.0


def test_nodrop_routes_agree(monkeypatch):
    """The gathered batched product and the loop over experts give the same
    numbers on the same tokens (fp32 rounding)."""
    m, _, _ = _moe(dict(CASES[4][1]))
    x = torch.tensor(rng.standard_normal((3, 4, D)).astype(np.float32))
    with torch.no_grad():
        monkeypatch.setattr(moe_mod, "GATHER_MAX", 0)
        loop = m.apply_with_aux(x)
        monkeypatch.setattr(moe_mod, "GATHER_MAX", 10 ** 6)
        gathered = m.apply_with_aux(x)
    np.testing.assert_allclose(loop[0].numpy(), gathered[0].numpy(), **TOL)
    assert float(loop[1]) == float(gathered[1])


# ---- ties ------------------------------------------------------------------

TIE_CASES = [
    # (id, fields, how the router is tied, the expert JAX picks first)
    ("softmax_k1_duplicated_column",
     dict(num_experts=8, hidden_units=16, router_top_k=1,
          capacity_factor=None), "dup", 2),
    ("softmax_k6_duplicated_column",
     dict(num_experts=16, hidden_units=16, router_top_k=6,
          router_weights="softmax", capacity_factor=None,
          shared_experts_units=16, ffn="swiglu"), "dup", 2),
    ("topk_softmax_duplicated_column",
     dict(num_experts=8, hidden_units=16, router_top_k=2,
          router_weights="topk_softmax", capacity_factor=None,
          ffn="glu_clamp"), "dup", 2),
    ("top2sum_equal_groups",
     dict(num_experts=16, hidden_units=16, router_top_k=2,
          router_weights="softmax_norm", router_score="sigmoid",
          router_groups=(4, 1), router_group_metric="top2sum",
          capacity_factor=None, ffn="swiglu"), "groups", 0),
    ("max_equal_groups_sorted",
     dict(num_experts=16, hidden_units=16, router_top_k=2,
          router_weights="softmax", router_groups=(4, 1),
          capacity_factor=2.0, dispatch_impl="sorted", ffn="geglu"),
     "groups", 0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", TIE_CASES, ids=[c[0] for c in TIE_CASES])
def test_ties_pick_jax_experts(case, dtype):
    """Equal scores: the lower index wins, as in jax.lax.top_k. Every token
    carries 3.0 in feature 0. ``dup``: router column 5 is a copy of column
    2, whose feature-0 weight 2.0 makes both lead for every token; ``groups``:
    groups 0 and 2 of the router are equal copies, led by a feature-0 weight
    of 3.0, so that their group scores tie exactly. The experts' weights
    differ, so a wrong pick shows in the output too."""
    _, fields, how, first = case
    m, jm, _ = _moe(fields, seed=7)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    x[..., 0] = 3.0
    xt = torch.tensor(x).to(dtype)
    with torch.no_grad():
        r = m.router
        if how == "dup":
            r[0, 2] = 2.0
            r[:, 5] = r[:, 2]
        else:
            per = fields["num_experts"] // fields["router_groups"][0]
            r[0, :per] = 3.0
            r[:, 2 * per:3 * per] = r[:, :per]
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  tree_to_numpy(dict(m.named_parameters())))
    want = _jax_moe(jm, tree, jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    with torch.no_grad():
        got = m.apply_with_aux(xt, collect_stats=True)
        _, i_k, _ = m._route(xt.reshape(-1, D))
    load = got[2]["expert_load"].numpy()
    if how == "dup":
        assert load[first] == 1.0 and load[5] == 0.0, load
        if fields["router_top_k"] > 1:
            assert bool((i_k[:, 1] == 5).all())
    else:
        per = fields["num_experts"] // 4
        assert bool((i_k < per).all()), i_k     # group 0, not group 2
    _compare(got, want, dtype)


# ---- the GPT --------------------------------------------------------------

DIMS = dict(kv_lora_rank=16, q_lora_rank=None, qk_nope_head_dim=8,
            qk_rope_head_dim=4, v_head_dim=8)
MOE = dict(moe_experts=8, moe_top_k=3, moe_capacity_factor=None,
           moe_router_weights="softmax", moe_shared_units=32,
           moe_hidden_units=16, moe_first_dense=1, moe_aux_weight=0.1)
MLA_MOE = dict(vocab_size=64, d_model=D, num_heads=4, num_layers=3,
               hidden_units=48, max_len=64, positional="rope", norm="rms",
               ffn="swiglu", use_bias=False, tie_embeddings=False,
               ln_eps=1e-6, rope_scaling=("yarn", 4.0, 32.0, 1.0, 16.0, 1.0),
               mla=DIMS, **MOE)
# A swiglu MoE GPT on ordinary pages (Mixtral's form, softmax_norm).
SWIGLU_MOE = dict(vocab_size=64, d_model=D, num_heads=4, num_kv_heads=2,
                  num_layers=2, hidden_units=48, max_len=64,
                  positional="rope", norm="rms", ffn="swiglu",
                  use_bias=False, ln_eps=1e-6, moe_experts=8, moe_top_k=2,
                  moe_capacity_factor=None,
                  moe_router_weights="softmax_norm")
# Capacity-limited GShard routing (mlp experts), learned positions.
CAPACITY_MOE = dict(vocab_size=64, d_model=D, num_heads=4, num_layers=2,
                    hidden_units=48, max_len=64, moe_experts=4, moe_top_k=2,
                    moe_capacity_factor=1.0)
V = 64


def _gpt(cfg, seed):
    """The port's GPT (embedding x 50, so that greedy tokens vary), JAX's
    GPT and its tree."""
    t = tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(seed))
    with torch.no_grad():
        t.embedding.table.mul_(50.0)
    tree = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(t))
    return t, jmodels.GPT(jmodels.GPTConfig(**cfg)), tree


@pytest.fixture(scope="module")
def mla_moe():
    return _gpt(MLA_MOE, 3)


def test_gpt_structure(mla_moe):
    """Layer 0 dense (swiglu 48), layers 1..2 routed with shared experts."""
    t = mla_moe[0]
    assert not t.layer_0.moe_experts and hasattr(t.layer_0, "swiglu")
    assert t.layer_1.moe.num_experts == 8 and not hasattr(t.layer_1, "swiglu")
    assert t.layer_2.moe.w_gate.shape == (8, D, 16)
    assert t.layer_2.moe.shared["w_gate"].shape == (D, 32)


def test_gpt_apply_loss_and_decode_vs_jax(mla_moe):
    """``apply`` logits and the summed aux, ``loss`` with moe_aux_weight x
    aux, each decode step's logits through the latent caches, and greedy
    ``generate`` token for token."""
    t, j, params = mla_moe
    toks = rng.integers(0, V, (2, 16))
    jt = jnp.asarray(toks)
    want, jaux = jax.jit(lambda p, x: j.apply(p, x, collect_aux=True))(
        params, jt)
    with torch.no_grad():
        got, aux = t.apply(torch.tensor(toks), collect_aux=True)
        loss = t.loss(torch.tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 1.0          # two MoE layers, about 1 each
    np.testing.assert_allclose(float(loss), float(jax.jit(j.loss)(params, jt)),
                               rtol=1e-5)
    step = jax.jit(lambda p, x, c: j.apply(p, x, caches=c, decode=True))
    jc = j.init_cache(2, 24)
    tc = t.init_cache(2, 24)
    with torch.no_grad():
        for lo, hi in ((0, 9), (9, 10), (10, 11), (11, 12)):
            want, jc = step(params, jt[:, lo:hi], jc)
            got, tc = t.apply(torch.tensor(toks[:, lo:hi]), caches=tc,
                              decode=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    prompt = rng.integers(0, V, (2, 9))
    gen = jax.jit(lambda p, x: j.generate(p, x, steps=8))
    want = np.asarray(gen(params, jnp.asarray(prompt)))
    got = t.generate(torch.tensor(prompt), steps=8).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.ravel().tolist())) > 3


def _traffic(eng, p1, p2, wrap):
    """Sequence 1 joins, a step, 2 joins, three steps, 2 leaves, a step."""
    g1, g2 = [eng.add_request(1, wrap(p1))], []
    g1.append(eng.step()[1])
    g2.append(eng.add_request(2, wrap(p2)))
    for _ in range(3):
        out = eng.step()
        g1.append(out[1])
        g2.append(out[2])
    eng.finish(2)
    g1.append(eng.step()[1])
    return g1, g2


@pytest.mark.parametrize("which,kw", [
    ("mla_moe", dict(prefill_chunk_size=4)),
    ("mla_moe", dict(prefill_chunk_size=256)),
    ("swiglu_moe", dict(prefill_chunk_size=4)),
    ("swiglu_moe", dict(prefill_chunk_size=256, kv_dtype="bf16")),
    ("capacity_moe", dict(prefill_chunk_size=256)),
    ("capacity_moe", dict(prefill_chunk_size=None)),
], ids=["mla_chunk4", "mla_chunk256", "swiglu_chunk4", "swiglu_bf16_pages",
        "capacity_dense_prefill", "capacity_no_chunk"])
def test_engine_vs_jax(mla_moe, which, kw):
    """Continuous batching (joins and a leave) with chunked prefill, token
    for token against JAX's engine; a capacity-limited MoE takes the dense
    prefill even with a chunk size. Every page comes home."""
    if which == "mla_moe":
        t, j, params = mla_moe
    else:
        t, j, params = _gpt(SWIGLU_MOE if which == "swiglu_moe"
                            else CAPACITY_MOE, 5)
    base = dict(total_pages=32, page_size=8, max_seqs=4)
    jkw, tkw = dict(base, **kw), dict(base, **kw)
    if kw.get("kv_dtype"):
        jkw["kv_dtype"], tkw["kv_dtype"] = jnp.bfloat16, torch.bfloat16
    jeng, teng = JaxEngine(j, params, **jkw), GenerationEngine(t, **tkw)
    assert teng._chunked == (which != "capacity_moe"
                             and kw["prefill_chunk_size"] is not None)
    free0 = teng.free_pages
    p1, p2 = rng.integers(0, V, 11), rng.integers(0, V, 6)
    got = _traffic(teng, p1, p2, lambda a: a)
    assert got == _traffic(jeng, p1, p2, jnp.asarray)
    teng.finish(1)
    assert teng.free_pages == free0
    if which == "mla_moe":
        gen = t.generate(torch.tensor(p1)[None], steps=6)
        assert got[0] == gen[0].tolist()


def test_refusals_as_jax():
    """JAX's asserts: capacity-limited MoE with the prefix cache or with MLA
    in the engine; window_pattern with moe_first_dense; moe_first_dense
    without experts; a bad router rule; apply_override."""
    cap, _, cap_params = _gpt(CAPACITY_MOE, 1)
    with pytest.raises(ValueError, match="prefix cache"):
        GenerationEngine(cap, total_pages=16, page_size=8,
                         enable_prefix_cache=True)
    with pytest.raises(AssertionError):
        JaxEngine(jmodels.GPT(jmodels.GPTConfig(**CAPACITY_MOE)), cap_params,
                  total_pages=16, page_size=8, enable_prefix_cache=True)
    mla_cap = dict(MLA_MOE, moe_capacity_factor=1.25)
    t, j, params = _gpt(mla_cap, 2)
    with pytest.raises(ValueError, match="capacity-limited MoE"):
        GenerationEngine(t, total_pages=16, page_size=8)
    with pytest.raises(AssertionError):
        JaxEngine(j, params, total_pages=16, page_size=8)
    windowed = dict(SWIGLU_MOE, attention_window=8, window_pattern=2,
                    moe_first_dense=1)
    with pytest.raises(AssertionError):
        jmodels.GPT(jmodels.GPTConfig(**windowed))
    with pytest.raises(ValueError, match="window_pattern"):
        tmodels.GPT(tmodels.GPTConfig(**windowed), device="cpu")
    with pytest.raises(ValueError, match="moe_experts"):
        tmodels.GPT(tmodels.GPTConfig(**dict(SWIGLU_MOE, moe_experts=0,
                                             moe_first_dense=1)),
                    device="cpu")
    with pytest.raises(ValueError, match="k > 2"):
        MoE(D, 8, 16, router_top_k=3, device="cpu")
    with pytest.raises(NotImplementedError, match="apply_override"):
        MoE(D, 8, 16, apply_override=lambda p, x: x, device="cpu")
    with pytest.raises(ValueError, match="scan_layers=False"):
        tmodels.GPT(tmodels.GPTConfig(**dict(MLA_MOE, scan_layers=True)),
                    device="cpu")


@pytest.mark.parametrize("cfg", [MLA_MOE, SWIGLU_MOE, CAPACITY_MOE],
                         ids=["mla_moe", "swiglu_moe", "mlp_moe"])
def test_params_round_trip(cfg):
    """JAX's tree structure (3-D expert leaves, moe/shared, the dense first
    layer) in, the same tree out."""
    t = tmodels.GPT(tmodels.GPTConfig(**cfg), device="cpu").init(
        torch.Generator().manual_seed(4))
    tree = params_to_numpy(t)
    jtree = jax.eval_shape(lambda: jmodels.GPT(jmodels.GPTConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)))
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(lambda a, b: a.shape == b.shape or pytest.fail(
        f"{a.shape} != {b.shape}"), jtree, tree)
    last = tree[f"layer_{cfg['num_layers'] - 1}"]["moe"]
    assert last["router"].shape == (D, cfg["moe_experts"])
    back = params_to_numpy(params_from_numpy(tree, tmodels.GPTConfig(**cfg),
                                             device="cpu"))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_load_balancing_loss_and_forward_vs_jax():
    """``load_balancing_loss`` (softmax gates, argmax first choice) and
    ``forward`` (JAX ``apply``) against JAX's."""
    fields = dict(CASES[8][1])
    m, jm, tree = _moe(fields, seed=3)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    with torch.no_grad():
        got = m.load_balancing_loss(torch.tensor(x))
        out = m(torch.tensor(x))
    np.testing.assert_allclose(
        float(got), float(jm.load_balancing_loss(tree, jnp.asarray(x))),
        rtol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jm.apply(tree, jnp.asarray(x))),
                               **TOL)


def test_int8_expert_leaves_raise():
    """Expert leaves are no JAX int8 target: a quantized leaf there raises
    as any leaf outside a Linear's weight does."""
    from np_modeling_tpu_torch import ops
    cfg = tmodels.GPTConfig(**SWIGLU_MOE)
    t = tmodels.GPT(cfg, device="cpu").init(torch.Generator().manual_seed(6))
    tree = ops.quantize_params_int8(params_to_numpy(t),
                                    match=r".*moe/w_up$")
    assert "int8" in tree["layer_0"]["moe"]["w_up"]
    with pytest.raises(NotImplementedError, match="quantized leaf"):
        params_from_numpy(tree, cfg, device="cpu")
