"""Grammar-constrained decoding of the PyTorch port against the JAX package,
on the CPU: ``serving.constrain``'s DFAs (``trans`` and ``start`` equal to
JAX's for choices, regexes and JSON schemas) and the engine's constrained
decoding token for token JAX's engine, with fork, finish, slot reuse,
``register_constraint``, sampling and an unconstrained slot beside
constrained ones.

The JAX constraint tests' toy vocabulary and tiny GPT
(tests/test_constrain.py) hold the port's seeded weights in both packages;
every finished output fullmatches its regex under Python's ``re``. fp32;
the JAX engine runs compiled.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from np_modeling_tpu import models as jmodels
from np_modeling_tpu.serving import GenerationEngine as JaxEngine
from np_modeling_tpu.serving import SamplingParams as JaxSamplingParams
from np_modeling_tpu.serving import constrain as jconstrain
from np_modeling_tpu_torch import models as tmodels
from np_modeling_tpu_torch.serving import (GenerationEngine, SamplingParams,
                                           constrain)
from np_modeling_tpu_torch.utils import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

# id 0 = EOS (the empty string), single chars and a few merges.
TOKS = [""] + list("abcdefgh0123456789-. ") + ["ab", "cd", "12", "true",
                                               "false", "0.5"]
EOS, V = 0, 64
TOKS += [""] * (V - len(TOKS))
# A JSON vocabulary: punctuation, quotes, digits, letters, keywords.
JTOKS = ([""] + list('{}[]:, "0123456789-.eE+abcdnorstuvxyz')
         + ['"name"', '"age"', "true", "false", "null", '": ', ", "])
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string", "maxLength": 3},
                         "age": {"type": "integer"},
                         "ok": {"type": "boolean"}},
          "required": ["name", "age"]}
PATTERNS = ["(true|false)", "-?[0-9]+(.[0-9]+)?", "ab*(cd)+", "[a-d] [e-h]",
            "[^0-9]+", "x?(ab|cd)*12"]
ENGINE = dict(total_pages=64, page_size=4, max_seqs=4)


def _gold(pattern):
    return re.compile("(?:" + pattern.replace("(", "(?:") + ")", re.S)


def _same_dfa(got, want):
    np.testing.assert_array_equal(np.asarray(got.trans),
                                  np.asarray(want.trans))
    assert got.start == want.start


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regex_dfa_equals_jax(pattern):
    _same_dfa(constrain.dfa_from_regex(pattern, TOKS, EOS),
              jconstrain.dfa_from_regex(pattern, TOKS, EOS))


def test_choices_and_json_schema_dfas_equal_jax():
    choices = [[TOKS.index("true")], [TOKS.index("false")],
               [TOKS.index("ab"), TOKS.index("cd")], [5, 6, 7]]
    _same_dfa(constrain.dfa_from_choices(choices, V, EOS),
              jconstrain.dfa_from_choices(choices, V, EOS))
    _same_dfa(constrain.dfa_from_json_schema(SCHEMA, JTOKS, 0),
              jconstrain.dfa_from_json_schema(SCHEMA, JTOKS, 0))
    arr = {"type": "array", "items": {"enum": [1, "x", None]},
           "minItems": 1, "maxItems": 3}
    _same_dfa(constrain.dfa_from_json_schema(arr, JTOKS, 0),
              jconstrain.dfa_from_json_schema(arr, JTOKS, 0))
    assert constrain.json_schema_ast(SCHEMA) == jconstrain.json_schema_ast(
        SCHEMA)
    for bad in (lambda m: m.dfa_from_choices([[]], V, EOS),
                lambda m: m.dfa_from_regex("zzz", TOKS, EOS),
                lambda m: m.json_schema_ast({"type": "tuple"})):
        with pytest.raises(ValueError):
            bad(constrain)


@pytest.fixture(scope="module")
def models():
    cfg = dict(vocab_size=V, d_model=32, num_heads=4, num_kv_heads=2,
               num_layers=2, hidden_units=64, max_len=96)
    tree = params_to_numpy(tmodels.GPT(tmodels.GPTConfig(**cfg),
                                       device="cpu").init(
        torch.Generator().manual_seed(0)))
    return (jmodels.GPT(jmodels.GPTConfig(**cfg)),
            jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, tmodels.GPTConfig(**cfg), device="cpu"))


def _engines(models, constraints, jax_sampling=None, **kw):
    jgpt, jparams, tgpt = models
    jdfas = {n: jconstrain.TokenDFA(trans=d.trans, start=d.start)
             for n, d in constraints.items()}
    return (JaxEngine(jgpt, jparams, constraints=jdfas,
                      sampling=jax_sampling, **ENGINE),
            GenerationEngine(tgpt, constraints=dict(constraints), **ENGINE,
                             **kw))


def _text(ids):
    return "".join(TOKS[t] for t in ids if t != EOS)


@pytest.mark.parametrize("pattern", PATTERNS[:4])
def test_constrained_greedy_vs_jax(models, pattern):
    """EOS carries a large logit bias, so a decode ends at its first
    accepting state; -inf must still win in the states that forbid EOS.
    A constrained slot and an unconstrained one share every step; the
    tokens equal JAX's and the finished text fullmatches the pattern."""
    dfa = constrain.dfa_from_regex(pattern, TOKS, EOS)
    jeng, teng = _engines(
        models, {"g": dfa}, JaxSamplingParams(logit_bias={EOS: 1e4}),
        sampling=SamplingParams(logit_bias={EOS: 1e4}))
    rng = np.random.default_rng(5)
    prompts = {0: rng.integers(0, V, 6), 1: rng.integers(0, V, 9)}
    first = teng.add_requests(prompts, constraints={0: "g"})
    assert first == jeng.add_requests(
        {k: jnp.asarray(v) for k, v in prompts.items()}, constraints={0: "g"})
    ids = [first[0]]
    for _ in range(12):
        out = teng.step()
        assert out == jeng.step()
        ids.append(out[0])
    done = ids[:ids.index(EOS) + 1] if EOS in ids else ids
    assert done[-1] == EOS, ids
    assert _gold(pattern).fullmatch(_text(done)), (pattern, ids)


def test_unconstrained_slot_and_fork_finish_reuse_register(models):
    """JAX's fork / finish / reuse flow token for token, the unconstrained
    slot equal to a constraint-free engine's stream, then a grammar
    registered at run time."""
    jgpt, jparams, tgpt = models
    num = constrain.dfa_from_regex("[0-9]+", TOKS, EOS)
    jeng, teng = _engines(models, {"num": num})
    rng = np.random.default_rng(6)
    p0, p1 = rng.integers(0, V, 6), rng.integers(0, V, 5)
    first = teng.add_requests({0: p0, 1: p1}, constraints={1: "num"})
    assert first == jeng.add_requests({0: jnp.asarray(p0),
                                       1: jnp.asarray(p1)},
                                      constraints={1: "num"})
    teng.fork(1, 2)
    jeng.fork(1, 2)
    out = teng.step_many(6)
    assert out == jeng.step_many(6)
    assert out[1] == out[2]                  # the child's grammar position
    plain = GenerationEngine(tgpt, total_pages=64, page_size=4)
    assert [first[0]] + out[0] == [plain.add_request(0, p0)] + \
        plain.step_many(6)[0]
    digits = [first[1]] + out[1]
    digits = digits[:digits.index(EOS)] if EOS in digits else digits
    assert all(c in "0123456789" for c in _text(digits)), digits
    for eng in (teng, jeng):
        for sid in (0, 1, 2):
            eng.finish(sid)
    assert teng._state["dfa_id"].tolist() == [0] * 4
    # A reused slot decodes unconstrained.
    assert teng.add_request(3, p1) == jeng.add_request(3, jnp.asarray(p1))
    assert teng.step() == jeng.step()
    with pytest.raises(ValueError, match="while sequences are live"):
        teng.register_constraint("num", num)
    teng.finish(3)
    jeng.finish(3)
    boolean = constrain.dfa_from_regex("(true|false)", TOKS, EOS)
    teng.register_constraint("bool", boolean)
    jeng.register_constraint("bool", jconstrain.TokenDFA(
        trans=boolean.trans, start=boolean.start))
    ids = [teng.add_request(4, p0, constraint="bool")]
    assert ids == [jeng.add_request(4, jnp.asarray(p0), constraint="bool")]
    out = teng.step_many(3)
    assert out == jeng.step_many(3)
    ids += out[4]
    assert _text(ids[:ids.index(EOS)] if EOS in ids else ids) in (
        "true", "false", "t", "f", "tr", "fa", "tru", "fal", "fals")
    with pytest.raises(ValueError, match="unknown constraint"):
        teng.add_request(5, p0, constraint="nope")
    with pytest.raises(ValueError, match="constraints="):
        GenerationEngine(tgpt, **ENGINE).add_request(0, p0, constraint="x")


def test_choices_and_json_on_the_engine(models):
    """A choices DFA and a JSON-schema DFA on one engine beside the JAX
    engine: the same tokens, and a finished choice is one of the choices."""
    choices = [[TOKS.index("true")], [TOKS.index("false")],
               [TOKS.index("ab"), TOKS.index("cd")]]
    cdfa = constrain.dfa_from_choices(choices, V, EOS)
    jeng, teng = _engines(models, {"c": cdfa})
    prompt = np.random.default_rng(7).integers(0, V, 7)
    ids = [teng.add_request(0, prompt, constraint="c")]
    assert ids == [jeng.add_request(0, jnp.asarray(prompt), constraint="c")]
    out = teng.step_many(3)
    assert out == jeng.step_many(3)
    ids += out[0]
    assert _text(ids[:ids.index(EOS)]) in ("true", "false", "abcd"), ids


def test_sampled_constrained_tokens_obey_the_grammar(models):
    """Masks survive the sampling processors (temperature, top-k and a
    repetition penalty): every sampled token before EOS is digits only."""
    _, _, tgpt = models
    num = constrain.dfa_from_regex("[0-9]+", TOKS, EOS)
    eng = GenerationEngine(tgpt, constraints={"num": num}, seed=2,
                           sampling=SamplingParams(temperature=1.5, top_k=20,
                                                   repetition_penalty=1.2),
                           **ENGINE)
    ids = [eng.add_request(0, np.arange(5), constraint="num")]
    ids += eng.step_many(10)[0]
    body = ids[:ids.index(EOS)] if EOS in ids else ids
    assert body and all(TOKS[t] and set(TOKS[t]) <= set("0123456789")
                        for t in body), ids
