"""The GPT's training options in the port against the JAX package: remat,
scan_layers, inputs_embeds / prompt_embeds, and the tied head at bf16
logits.

remat: the port's loss and every gradient with ``remat=True`` equal its own
without remat bit for bit, dropout 0.1 on, for a GPT, an MoE GPT and a
Gemma-style window/softcap GPT (the recomputed forward draws the same dropout
masks from the same integer seeds, and the test watches it do so); and
agree with JAX's ``remat=True``. scan_layers: JAX's stacked layout
(``layers.self_attention.wq`` [L, ...]) in forward, ``GPT.loss`` gradients,
the MoE aux, segment ids with positions, dense-cache decode and ``generate``
against JAX's scanned GPT, mirroring tests/test_scan_remat.py, and the
three refusals JAX asserts. Weights come from the port's seeded init,
carried to JAX by utils.convert; the JAX side runs under ``jax.jit``. fp32
at rtol 1e-5 / atol 2e-5 (BASELINE.md:16), gradients at atol 5e-5 as the
other GPT tests hold them, unless a case states otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.ops import normalization as tnorm
from np_modeling_tpu_torch.serving import GenerationEngine
from np_modeling_tpu_torch.utils import (params_from_numpy, params_to_numpy,
                                         tree_to_numpy)

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=5e-5)
rng = np.random.default_rng(24)
V = 50

BASE = dict(vocab_size=V, d_model=32, num_heads=4, num_layers=3,
            hidden_units=64, max_len=16)
CONFIGS = {
    "gpt": BASE,
    "moe": dict(BASE, moe_experts=4, moe_top_k=2),
    # Gemma-2's form: local/global alternation, both softcaps, RMSNorm with
    # the offset, sandwich norms, GeGLU, RoPE, the embedding scaled.
    "gemma": dict(BASE, num_kv_heads=2, head_dim=16, positional="rope",
                  norm="rms", ln_eps=1e-6, rms_offset=True, ffn="geglu",
                  use_bias=False, embed_scale=True, sandwich_norm=True,
                  attention_window=4, window_pattern=2,
                  attn_logit_softcap=2.0, final_logit_softcap=3.0),
}


def _tokens(b=2, s=12):
    return rng.integers(0, V, (b, s)).astype(np.int32)


def _port(cfg, seed=0, dtype=None):
    return tmodels.GPT(tmodels.GPTConfig(**cfg, dtype=dtype),
                       device="cpu").init(torch.Generator().manual_seed(seed))


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, params_to_numpy(t))


def _grads(t):
    return {n: p.grad for n, p in t.named_parameters()}


def _assert_trees_close(got, want, **tol):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, g in flat_got:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_loss_grad():
    """``get(cfg)``: JAX's jitted ``value_and_grad`` of ``GPT.loss(params,
    tokens, segment_ids, positions)`` for a config, built once a config and
    shared across cases."""
    cache = {}

    def get(cfg):
        key = repr(sorted(cfg.items()))
        if key not in cache:
            jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
            cache[key] = jax.jit(jax.value_and_grad(
                lambda p, t, seg, pos: jgpt.loss(p, t, segment_ids=seg,
                                                 positions=pos)))
        return cache[key]

    return get


# ---- remat ----------------------------------------------------------------------

def _loss_and_grads(t, tokens, seed, positions=None):
    for p in t.parameters():
        p.grad = None
    loss = t.loss(torch.tensor(tokens), training=True,
                  rngs={"dropout": seed}, positions=positions)
    loss.backward()
    return loss.detach(), _grads(t)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_bit_equal_to_no_remat_with_dropout(monkeypatch, name):
    """Dropout 0.1 on every site: the remat model (the same weights) gives
    the loss and every gradient of the model without remat bit for bit, and
    each block's recompute draws exactly the masks its forward drew."""
    cfg = dict(CONFIGS[name], drop_rate=0.1)
    plain = _port(cfg, seed=1)
    remat = params_from_numpy(params_to_numpy(plain),
                              tmodels.GPTConfig(**cfg, remat=True),
                              device="cpu")
    masks = []
    draw = tnorm.make_dropout_mask

    def spy(seed, shape, rate, device=None):
        masks.append((seed, draw(seed, shape, rate, device)))
        return masks[-1][1]

    monkeypatch.setattr(tnorm, "make_dropout_mask", spy)
    tokens = _tokens()
    l0, g0 = _loss_and_grads(plain, tokens, 7)
    drawn = list(masks)
    masks.clear()
    l1, g1 = _loss_and_grads(remat, tokens, 7)
    assert torch.equal(l0, l1)
    assert set(g0) == set(g1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # The embedding's mask, then two a block; under remat each block's two
    # are drawn again in the backward (the last block first), from the same
    # seeds: the same bits.
    L = cfg["num_layers"]
    assert len(drawn) == 1 + 2 * L and len(masks) == 1 + 4 * L
    fwd, again = masks[:1 + 2 * L], masks[1 + 2 * L:]
    for (s0, m0), (s1, m1) in zip(drawn, fwd):
        assert s0 == s1 and torch.equal(m0, m1)
    for i in range(L):
        blk = fwd[1 + 2 * i: 3 + 2 * i]
        rec = again[2 * (L - 1 - i): 2 * (L - i)]
        for (s0, m0), (s1, m1) in zip(blk, rec):
            assert s0 == s1 and torch.equal(m0, m1), i


@pytest.mark.parametrize("name", sorted(CONFIGS) + ["rope_positions"])
def test_remat_vs_jax(jax_loss_grad, name):
    """The remat model's loss and gradients against JAX's ``remat=True``
    (dropout off: the masks are the port's own bits); ``rope_positions``
    passes per-document positions through the checkpointed blocks."""
    cfg = (dict(BASE, positional="rope") if name == "rope_positions"
           else CONFIGS[name])
    t = _port(dict(cfg, remat=True), seed=2)
    tokens = _tokens()
    pos = (np.tile(np.arange(6), 2)[None].repeat(2, 0).astype(np.int32)
           if name == "rope_positions" else None)
    for p in t.parameters():
        p.grad = None
    got = t.loss(torch.tensor(tokens),
                 positions=None if pos is None else torch.tensor(pos))
    got.backward()
    want, jg = jax_loss_grad(dict(cfg, remat=True))(
        _jtree(t), jnp.asarray(tokens), None,
        None if pos is None else jnp.asarray(pos))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    _assert_trees_close(tree_to_numpy(_grads(t)), jg, **GRAD_TOL)


def test_remat_leaves_decode_and_no_grad_alone():
    """remat runs only where a gradient is taken: ``torch.no_grad`` forwards
    and dense-cache decoding give the model's values unchanged."""
    t = _port(dict(BASE, remat=True), seed=3)
    plain = params_from_numpy(params_to_numpy(t), tmodels.GPTConfig(**BASE),
                              device="cpu")
    tokens = torch.tensor(_tokens())
    with torch.no_grad():
        assert torch.equal(t.apply(tokens), plain.apply(tokens))
    assert torch.equal(t.generate(tokens[:, :4], steps=5),
                       plain.generate(tokens[:, :4], steps=5))


# ---- scan_layers -----------------------------------------------------------------

def _scan_pair(cfg, seed=0):
    """A scanned port GPT and its stacked tree for JAX (``layers/...``)."""
    t = _port(dict(cfg, scan_layers=True), seed)
    return t, _jtree(t)


def test_scan_layout_is_jax_stacked_tree():
    """``GPTConfig(scan_layers=True)``'s parameters are JAX's scanned tree:
    the same paths and shapes as JAX's ``init``, [L, ...] under ``layers``;
    params_from_numpy carries that tree into the port and back."""
    cfg = dict(BASE, scan_layers=True)
    t = _port(cfg, seed=4)
    jtree = jmodels.GPT(jmodels.GPTConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                 tree)
    assert shapes(params_to_numpy(t)) == shapes(jtree)
    assert t.layers.self_attention.wq.shape[0] == 3
    back = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             tmodels.GPTConfig(**cfg), device="cpu")
    _assert_trees_close(params_to_numpy(back), jtree, rtol=0, atol=0)
    # Each layer drew its own weights.
    wq = t.layers.self_attention.wq
    assert not torch.equal(wq[0], wq[1])


@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_scan_forward_and_grads_vs_jax(jax_loss_grad, positional):
    """The scanned forward's logits and ``GPT.loss``'s gradients (the
    stacked leaves against JAX's ``g["layers"]``), with and without remat."""
    cfg = dict(BASE, positional=positional)
    t, tree = _scan_pair(cfg, seed=5)
    tokens = _tokens()
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg, scan_layers=True))
    with torch.no_grad():
        got = t.apply(torch.tensor(tokens))
    want = jax.jit(jgpt.apply)(tree, jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for remat in (False, True):
        t.config = dataclasses.replace(t.config, remat=remat)
        for p in t.parameters():
            p.grad = None
        loss = t.loss(torch.tensor(tokens))
        loss.backward()
        wl, jg = jax_loss_grad(dict(cfg, scan_layers=True, remat=remat))(
            tree, jnp.asarray(tokens), None, None)
        np.testing.assert_allclose(loss.item(), float(wl), **TOL)
        _assert_trees_close(tree_to_numpy(_grads(t)), jg, **GRAD_TOL)


def test_scan_equals_loop_in_the_port():
    """The scanned GPT on the loop GPT's weights, stacked, gives the loop's
    logits and the loop's gradients, each layer's in its slice of the
    stack (as test_scan_equals_loop_forward_and_grads does in JAX)."""
    loop = _port(BASE, seed=6)
    tree = params_to_numpy(loop)
    stacked = {k: v for k, v in tree.items() if not k.startswith("layer_")}
    stacked["layers"] = jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *[tree[f"layer_{i}"] for i in range(3)])
    scan = params_from_numpy(stacked, tmodels.GPTConfig(**BASE,
                                                        scan_layers=True),
                             device="cpu")
    tokens = torch.tensor(_tokens())
    for m in (loop, scan):
        m.loss(tokens).backward()
    with torch.no_grad():
        np.testing.assert_allclose(scan.apply(tokens).numpy(),
                                   loop.apply(tokens).numpy(), **TOL)
    gl, gs = _grads(loop), _grads(scan)
    for n, g in gs.items():
        if n.startswith("layers."):
            for i in range(3):
                np.testing.assert_allclose(
                    g[i].numpy(), gl[f"layer_{i}" + n[6:]].numpy(),
                    **GRAD_TOL, err_msg=f"{n}[{i}]")
        else:
            np.testing.assert_allclose(g.numpy(), gl[n].numpy(), **GRAD_TOL,
                                       err_msg=n)


def test_scan_moe_aux_vs_jax(jax_loss_grad):
    """An MoE GPT scanned: the loss carries each layer's load-balancing aux
    (nonzero), and the aux itself, against JAX's scanned GPT."""
    cfg = CONFIGS["moe"]
    t, tree = _scan_pair(cfg, seed=7)
    tokens = _tokens()
    loss = t.loss(torch.tensor(tokens))
    loss.backward()
    wl, jg = jax_loss_grad(dict(cfg, scan_layers=True))(
        tree, jnp.asarray(tokens), None, None)
    np.testing.assert_allclose(loss.item(), float(wl), **TOL)
    _assert_trees_close(tree_to_numpy(_grads(t)), jg, **GRAD_TOL)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg, scan_layers=True))
    _, jaux = jax.jit(lambda p, x: jgpt.apply(p, x, collect_aux=True))(
        tree, jnp.asarray(tokens))
    with torch.no_grad():
        _, aux = t.apply(torch.tensor(tokens), collect_aux=True)
    assert aux.item() > 0
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("positional", ["learned", "rope"])
def test_scan_segment_ids_and_positions_vs_jax(positional):
    """Packed documents through the scanned blocks: the logits against
    JAX's scanned GPT, and the first document blind to the second's
    tokens."""
    cfg = dict(BASE, positional=positional)
    t, tree = _scan_pair(cfg, seed=8)
    tokens = _tokens()
    segs = np.broadcast_to(np.repeat([0, 1], 6), (2, 12)).astype(np.int32)
    pos = np.tile(np.arange(6), 2)[None].repeat(2, 0).astype(np.int32)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg, scan_layers=True))
    want = jax.jit(lambda p, x, s, q: jgpt.apply(p, x, segment_ids=s,
                                                 positions=q))(
        tree, jnp.asarray(tokens), jnp.asarray(segs), jnp.asarray(pos))
    with torch.no_grad():
        run = lambda x: t.apply(torch.tensor(x), segment_ids=torch.tensor(
            segs), positions=torch.tensor(pos))
        got = run(tokens)
        tokens2 = tokens.copy()
        tokens2[:, 6:] = (tokens2[:, 6:] + 1) % V
        got2 = run(tokens2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got[:, :6], got2[:, :6])


def test_scan_dense_cache_decode_and_generate_vs_jax():
    """Stacked dense caches (``init_cache``: [L, ...] tensors, one shared
    ``index``): one token at a time gives the full forward's logits, and
    ``generate`` (greedy) gives JAX's scanned GPT's tokens."""
    t, tree = _scan_pair(BASE, seed=9)
    with torch.no_grad():
        t.embedding.table.mul_(20.0)      # so that greedy tokens vary
    tree = _jtree(t)
    tokens = _tokens(s=10)
    caches = t.init_cache(batch=2, max_len=12)
    assert caches["k"].shape == caches["v"].shape == (3, 2, 4, 12, 8)
    outs = []
    with torch.no_grad():
        full = t.apply(torch.tensor(tokens))
        for i in range(10):
            lg, caches = t.apply(torch.tensor(tokens[:, i:i + 1]),
                                 caches=caches, decode=True)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**BASE, scan_layers=True))
    want = jax.jit(lambda p, x: jgpt.generate(p, x, steps=6))(
        tree, jnp.asarray(tokens[:, :4]))
    got = t.generate(torch.tensor(tokens[:, :4]), steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.numpy().ravel().tolist())) > 1


@pytest.mark.parametrize("case", ["window_pattern", "moe_first_dense",
                                  "engine"])
def test_scan_refusals_as_jax(case):
    """Where JAX asserts, the port raises ValueError naming the rule."""
    if case == "window_pattern":
        with pytest.raises(ValueError, match="window_pattern"):
            tmodels.GPT(tmodels.GPTConfig(**CONFIGS["gemma"],
                                          scan_layers=True), device="cpu")
    elif case == "moe_first_dense":
        with pytest.raises(ValueError, match="scan_layers=False"):
            tmodels.GPT(tmodels.GPTConfig(**CONFIGS["moe"], moe_first_dense=1,
                                          scan_layers=True), device="cpu")
    else:
        t = _port(dict(BASE, scan_layers=True))
        with pytest.raises(ValueError, match="scan_layers=False"):
            GenerationEngine(t, total_pages=16, page_size=4, max_seqs=2)


# ---- inputs_embeds / prompt_embeds ----------------------------------------------------

def test_inputs_embeds_vs_jax():
    """``inputs_embeds`` in place of the token lookup: the logits against
    JAX's, and equal to the tokens' own when the embeddings are the
    table's rows; an ``embed_scale`` model refuses them, as JAX asserts."""
    t = _port(BASE, seed=10)
    tree = _jtree(t)
    tokens = _tokens()
    emb = rng.standard_normal((2, 12, 32)).astype(np.float32)
    jgpt = jmodels.GPT(jmodels.GPTConfig(**BASE))
    want = jax.jit(lambda p, e: jgpt.apply(p, None, inputs_embeds=e))(
        tree, jnp.asarray(emb))
    with torch.no_grad():
        got = t.apply(None, inputs_embeds=torch.tensor(emb))
        own = t.apply(None, inputs_embeds=t.embedding.table[
            torch.tensor(tokens)])
        np.testing.assert_array_equal(own.numpy(),
                                      t.apply(torch.tensor(tokens)).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    scaled = _port(CONFIGS["gemma"])
    with pytest.raises(ValueError, match="pre-scale"):
        scaled.apply(None, inputs_embeds=torch.tensor(emb))


@pytest.mark.parametrize("scan", [False, True])
def test_prompt_embeds_generate_vs_jax(scan):
    """``generate(prompt_embeds=)`` prefills from embeddings and decodes
    tokens after: JAX's greedy tokens, and the tokens' own prefill's when
    the embeddings are the prompt's rows."""
    cfg = dict(BASE, scan_layers=scan)
    t = _port(cfg, seed=11)
    with torch.no_grad():
        t.embedding.table.mul_(20.0)
    tree = _jtree(t)
    emb = rng.standard_normal((2, 5, 32)).astype(np.float32) * 20
    jgpt = jmodels.GPT(jmodels.GPTConfig(**cfg))
    want = jax.jit(lambda p, e: jgpt.generate(p, None, steps=6,
                                              prompt_embeds=e))(
        tree, jnp.asarray(emb))
    got = t.generate(None, steps=6, prompt_embeds=torch.tensor(emb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tokens = torch.tensor(_tokens(s=5))
    with torch.no_grad():
        rows = t.embedding.table[tokens]
    assert torch.equal(t.generate(None, steps=4, prompt_embeds=rows),
                       t.generate(tokens, steps=4))


# ---- the tied head at bf16 logits ---------------------------------------------------

def test_bf16_head_vs_jax():
    """A bf16 GPT's tied head at ``logits_dtype=bf16`` (as ``GPT.loss`` asks
    for it) is one bf16 product with fp32 accumulation and a bf16 result:
    on the same hidden states it gives JAX's head (its einsum with
    ``preferred_element_type=float32``, then ``astype(bf16)``) within one
    bf16 rounding (rtol 2**-8, the sums' orders differ); through the whole
    model the logits are within 2**-5 x max |JAX's| of JAX's bf16 GPT's
    (the blocks round in bf16 in other orders) and the loss within 2e-3
    relative. At fp32 logits the head stays the fp32 product of the bf16
    operands' exact copies."""
    t = _port(BASE, seed=12, dtype=torch.bfloat16)
    with torch.no_grad():
        t.embedding.table.mul_(20.0)
    tree = _jtree(t)
    tokens = _tokens()
    jgpt = jmodels.GPT(jmodels.GPTConfig(**BASE, dtype=jnp.bfloat16))
    with torch.no_grad():
        hidden = t.apply(torch.tensor(tokens), return_hidden=True)
        head = t.head(hidden, torch.bfloat16)
        got = t.apply(torch.tensor(tokens), logits_dtype=torch.bfloat16)
        f32 = t.apply(torch.tensor(tokens))
        table = t.embedding.table.to(torch.bfloat16)
    assert head.dtype == got.dtype == torch.bfloat16
    jhead = jnp.einsum("...d,vd->...v",
                       jnp.asarray(hidden.float().numpy()).astype(jnp.bfloat16),
                       jnp.asarray(table.float().numpy()).astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    np.testing.assert_allclose(head.float().numpy(),
                               np.asarray(jhead.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-6)
    want = jax.jit(lambda p, x: jgpt.apply(p, x, logits_dtype=jnp.bfloat16))(
        tree, jnp.asarray(tokens))
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got.float().numpy() - want).max() <= \
        2 ** -5 * np.abs(want).max()
    by_hand = hidden.float() @ table.float().t()
    np.testing.assert_allclose(f32.numpy(), by_hand.numpy(), rtol=1e-5,
                               atol=1e-5)
    jl = jax.jit(jgpt.loss)(tree, jnp.asarray(tokens))
    with torch.no_grad():
        tl = t.loss(torch.tensor(tokens))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-3)
