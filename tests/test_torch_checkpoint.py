"""Checkpoints of the port (training/checkpoint.py) and the training entry
point's ``--remat --ckpt``.

A run of 3 steps, a save of the parameters and the optimizer state, a load
into a fresh model and a fresh state, and 2 more steps give the losses and
parameters of 5 straight steps bit for bit (dropout on, the donated
recipe). A write that fails leaves neither a file nor a temporary, and the
old file as it was; a wrong shape, a missing leaf, an extra leaf or a leaf
of the wrong kind raises; the restore keeps the target's dtypes and
structure (NamedTuples, tuples, Python scalars). ``train_gpt.main([...,
"--remat", "--ckpt", path])`` saves parameters that, carried to JAX by
``params_to_numpy``, give JAX's ``GPT.loss`` equal to the port's (fp32,
rtol 1e-5 / atol 2e-5, BASELINE.md:16; the JAX side under ``jax.jit``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch import train_gpt, training
from np_modeling_tpu_torch.training import checkpoint as ckpt_mod
from np_modeling_tpu_torch.utils import params_to_numpy

# Tier-1 runs several pytest workers side by side: one intra-op thread
# each keeps torch from oversubscribing the cores.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=2e-5)
CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
           hidden_units=64, max_len=16, drop_rate=0.1)
STEPS = 5


def _gpt(seed, **kw):
    return tmodels.GPT(tmodels.GPTConfig(**CFG, **kw), device="cpu").init(
        torch.Generator().manual_seed(seed))


def _batches():
    r = np.random.default_rng(9)
    return [torch.tensor(r.integers(0, 64, (4, 16))) for _ in range(STEPS)]


def _steps(gpt, state, opt, batches, first):
    """The donated recipe step on ``batches``, step ``i``'s dropout seed
    ``i``; returns (losses, params, state)."""
    step = training.make_train_step(gpt.loss, lambda loss, _: loss, opt)
    params = dict(gpt.named_parameters())
    losses = []
    for i, tokens in enumerate(batches, start=first):
        params, state, loss = step(params, state, tokens, None, i)
        losses.append(loss)
    return losses, params, state


@pytest.mark.parametrize("remat", [False, True])
def test_resume_is_bit_equal_to_straight_steps(tmp_path, remat):
    batches = _batches()
    opt = train_gpt.recipe(STEPS)
    straight = _gpt(0, remat=remat)
    want, want_p, _ = _steps(straight, opt.init(dict(
        straight.named_parameters())), opt, batches, 0)

    first = _gpt(0, remat=remat)
    l3, p3, s3 = _steps(first, opt.init(dict(first.named_parameters())), opt,
                        batches[:3], 0)
    path = str(tmp_path / "run.ckpt")
    training.save_checkpoint(path, {"params": p3, "opt_state": s3})
    assert sorted(os.listdir(tmp_path)) == ["run.ckpt"]

    fresh = _gpt(1, remat=remat)            # other weights, a new state
    params = dict(fresh.named_parameters())
    target = {"params": params, "opt_state": opt.init(params)}
    assert not torch.equal(params["embedding.table"],
                           p3["embedding.table"])
    restored = training.load_checkpoint(path, target)
    assert restored["params"]["embedding.table"] is params["embedding.table"]
    assert type(restored["opt_state"][1]) is training.AdamState
    l5, p5, _ = _steps(fresh, restored["opt_state"], opt, batches[3:], 3)
    assert torch.equal(torch.stack(l3 + l5), torch.stack(want))
    for k, p in p5.items():
        assert torch.equal(p, want_p[k]), k


def test_failed_write_leaves_no_file_and_keeps_the_old(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "a.ckpt")
    training.save_checkpoint(path, {"w": torch.ones(3)})
    before = open(path, "rb").read()

    def broken(obj, f, *a, **k):
        f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        training.save_checkpoint(path, {"w": torch.zeros(3)})
    with pytest.raises(OSError, match="disk full"):
        training.save_checkpoint(str(tmp_path / "b.ckpt"),
                                 {"w": torch.zeros(3)})
    assert sorted(os.listdir(tmp_path)) == ["a.ckpt"]
    assert open(path, "rb").read() == before


@pytest.mark.parametrize("case", ["shape", "missing", "extra", "kind"])
def test_mismatched_target_raises(tmp_path, case):
    path = str(tmp_path / "c.ckpt")
    training.save_checkpoint(path, {"a": torch.ones(2),
                                    "w": torch.ones(2, 3), "n": 4})
    target, err = {
        "shape": ({"a": torch.zeros(2), "w": torch.zeros(3, 2), "n": 0},
                  ValueError),
        "missing": ({"a": torch.zeros(2), "w": torch.zeros(2, 3), "n": 0,
                     "b": torch.zeros(1)}, KeyError),
        "extra": ({"a": torch.zeros(2), "w": torch.zeros(2, 3)}, KeyError),
        "kind": ({"a": torch.zeros(2), "w": torch.zeros(2, 3),
                  "n": torch.zeros(())}, TypeError),
    }[case]
    with pytest.raises(err):
        training.load_checkpoint(path, target)
    # Nothing of the target was written, the leaves before the fault
    # included.
    for k, v in target.items():
        if torch.is_tensor(v):
            assert not v.any(), k


def test_restore_keeps_dtypes_and_structure(tmp_path):
    """Tensors come back in the target's dtype (a bf16 target from an fp32
    save), tuples, NamedTuples and Python scalars in their places; a file
    of another format is refused."""
    tree = {"state": (training.AdamState(torch.tensor(3, dtype=torch.int32),
                                         {"w": torch.full((2,), 0.5)},
                                         {"w": torch.full((2,), 0.25)}), ()),
            "step": 7, "lr": 0.125, "w": torch.arange(4.0)}
    path = str(tmp_path / "d.ckpt")
    training.save_checkpoint(path, tree)
    target = {"state": (training.AdamState(torch.zeros((), dtype=torch.int32),
                                           {"w": torch.zeros(2)},
                                           {"w": torch.zeros(2)}), ()),
              "step": 0, "lr": 0.0, "w": torch.zeros(4, dtype=torch.bfloat16)}
    got = training.load_checkpoint(path, target)
    assert got["step"] == 7 and got["lr"] == 0.125
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].float(), torch.arange(4.0))
    s = got["state"][0]
    assert type(s) is training.AdamState and int(s.count) == 3
    assert torch.equal(s.nu["w"], torch.full((2,), 0.25))
    assert got["state"][1] == ()
    other = str(tmp_path / "e.pt")
    torch.save({"w": torch.ones(1)}, other)
    with pytest.raises(ValueError, match="not a"):
        training.load_checkpoint(other, {"w": torch.zeros(1)})


def test_train_gpt_remat_ckpt_loads_into_jax(tmp_path):
    """``--remat --ckpt``: the saved parameters, reloaded into a fresh port
    GPT of the entry point's config and carried to JAX, give JAX's
    ``GPT.loss`` equal to the port's, and they are the trained ones (not
    the fresh model's)."""
    path = str(tmp_path / "gpt.ckpt")
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--d-model", "32", "--layers", "2", "--heads", "4", "--vocab",
            "64", "--remat", "--ckpt", path]
    losses = train_gpt.main(argv)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    cfg = train_gpt.config(train_gpt.parse_args(argv))
    assert cfg.remat
    fresh = tmodels.GPT(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    before = fresh.embedding.table.clone()
    training.load_checkpoint(path, dict(fresh.named_parameters()))
    assert not torch.equal(before, fresh.embedding.table)
    tokens = np.random.default_rng(2).integers(0, 64, (2, 16)).astype(
        np.int32)
    jgpt = jmodels.GPT(jmodels.GPTConfig(
        vocab_size=64, d_model=32, num_heads=4, num_layers=2,
        hidden_units=128, max_len=16, drop_rate=0.1, remat=True))
    tree = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(fresh))
    want = jax.jit(jgpt.loss)(tree, jnp.asarray(tokens))
    with torch.no_grad():
        got = fresh.loss(torch.tensor(tokens))
    np.testing.assert_allclose(got.item(), float(want), **TOL)
