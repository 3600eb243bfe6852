"""Port parity, the decode slice: B6's plain version against the JAX
package's oracle (``ref.decode_attention_ref``) over the flash-decode
sweep with length poisoning; reduced ``minitron_4b`` and ``starcoder2_7b``
teacher-forced through the port's ``prefill`` / ``decode_step`` on the
JAX package's parameters (``params_from_reference``) against the JAX
package's own; ``BatchedDecoder`` within the port (batched ≡ sequential
bitwise, more requests than slots, ``max_new == 1``, a hand loop); the
engine's per-call search parameters (ROADMAP C6); and the numerics
primitives the translation can get wrong (gelu's default, RoPE's layout,
bf16 leaves crossing from numpy).

Tiers: the oracle sweep at 1e-5 (f32) and 2e-2 (bf16), as the JAX
package's own kernel test.  Logits allclose at 2e-2 on bf16 parameters
and 1e-4 on f32 parameters, tokens equal on f32 parameters wherever the
JAX package's top-2 gap exceeds 1e-3: its decode casts the softmax
weights to the cache dtype before the value product
(``models/attention.py:336``), the port's keeps that product in f32, so
bf16 tokens and bitwise logits are not asked.  Within the port, bitwise.
No test builds a model at full width.
"""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest

if importlib.util.find_spec("torch") is None:
    pytest.skip("the port needs torch", allow_module_level=True)

import jax
import jax.numpy as jnp

from repro import arch as RA
from repro.configs import reduced_arch as ref_reduced_arch
from repro.kernels import ref as jref
from repro.models import common as jcommon

# The port is imported by the ``_port`` fixture, not at collection (see
# tests/test_torch_engine.py).
torch = PA = pcommon = pconfigs = pfd = pops = ptf = pserve = None
PortEngine = pcore = None


@pytest.fixture(autouse=True, scope="module")
def _port():
    global torch, PA, pcommon, pconfigs, pfd, pops, ptf, pserve
    global PortEngine, pcore
    import torch
    from repro_torch import arch as PA
    from repro_torch import configs as pconfigs
    from repro_torch import core as pcore
    from repro_torch import serve as pserve
    from repro_torch.core import LabelHybridEngine as PortEngine
    from repro_torch.kernels import flash_decode as pfd
    from repro_torch.kernels import ops as pops
    from repro_torch.models import common as pcommon
    from repro_torch.models import transformer as ptf
    # release the JAX programs compiled in this worker before this
    # module (and, at the end, by it): each holds memory maps, and
    # a worker that reaches vm.max_map_count segfaults in its next
    # XLA compile (ROADMAP C1)
    jax.clear_caches()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _t(a, dtype=None):
    """numpy (or a JAX array) -> CPU tensor; bf16 through f32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _f32(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# B6: the plain version against the JAX package's oracle
# ---------------------------------------------------------------------------

SWEEP = [
    (2, 256, 2, 4, 64),        # GQA
    (1, 512, 1, 8, 128),       # MQA, aligned dims
    (3, 384, 4, 1, 32),        # MHA, S not a power of two
    (2, 128, 8, 2, 16),        # many kv heads
]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(B, S, KH, G, Dh, dtype, seed=0):
    """The JAX test's inputs, rounded to ``dtype`` by JAX, and the same
    values as port tensors."""
    rng = np.random.default_rng(seed)
    jdt = jnp.dtype(dtype)
    jq = jnp.asarray(rng.standard_normal((B, KH * G, Dh)), jdt)
    jk = jnp.asarray(rng.standard_normal((B, S, KH, Dh)), jdt)
    jv = jnp.asarray(rng.standard_normal((B, S, KH, Dh)), jdt)
    lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
    return (jq, jk, jv, lengths), tuple(_t(a) for a in (jq, jk, jv, lengths))


def _port_decode(q, k, v, lengths):
    """ops.flash_decode on CPU tensors, which must equal the kernel
    wrapper's CPU path (the plain version) exactly."""
    out = pops.flash_decode(q, k, v, lengths)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.equal(out, pfd.flash_decode(q, k, v, lengths))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_reference_oracle(dtype):
    """The JAX package's sweep (GQA, MQA, MHA with S not a power of two,
    many KV heads) at its tolerance for ``dtype``."""
    for shape in SWEEP:
        (jq, jk, jv, lengths), (q, k, v, tl) = _case(*shape, dtype)
        want = np.asarray(jref.decode_attention_ref(jq, jk, jv,
                                                    jnp.asarray(lengths)),
                          np.float32)
        got = _port_decode(q, k, v, tl)
        np.testing.assert_allclose(_f32(got), want, atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=str(shape))


def test_flash_decode_lengths_and_single_block():
    """Slots past a row's length do not contribute: poisoning them with
    ±1e4 changes nothing, and both agree with the JAX oracle; one
    128-slot block alone agrees too.  The split length the kernel uses
    depends on S alone."""
    (jq, jk, jv, _), (q, k, v, _) = _case(2, 256, 2, 2, 32, "float32",
                                          seed=3)
    lengths = np.array([100, 17], np.int32)
    base = _port_decode(q, k, v, _t(lengths))
    k2, v2 = k.clone(), v.clone()
    k2[0, 100:], k2[1, 17:] = 1e4, -1e4
    v2[0, 100:], v2[1, 17:] = 1e4, -1e4
    poisoned = _port_decode(q, k2, v2, _t(lengths))
    np.testing.assert_allclose(_f32(poisoned), _f32(base), atol=1e-5)
    want = np.asarray(jref.decode_attention_ref(jq, jk, jv,
                                                jnp.asarray(lengths)))
    np.testing.assert_allclose(_f32(poisoned), want, atol=1e-5, rtol=1e-5)
    assert [pfd.split_len(S) for S in (1, 127, 2048, 4096, 32_768)] \
        == [128, 128, 128, 128, 512]
    (jq, jk, jv, lengths), (q, k, v, tl) = _case(1, 128, 2, 2, 64,
                                                 "float32", seed=5)
    want = np.asarray(jref.decode_attention_ref(jq, jk, jv,
                                                jnp.asarray(lengths)))
    np.testing.assert_allclose(_f32(_port_decode(q, k, v, tl)), want,
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# numerics primitives and weights
# ---------------------------------------------------------------------------

def test_common_numerics_and_specs_match_reference():
    """Activations (jax.nn.gelu is the tanh form by default; torch's
    gelu is exact unless asked), RoPE's half-split layout, RMSNorm and
    the embedding lookup against the JAX package's, in f32; parameter
    counts of both ported configs equal the JAX package's at full width
    (no allocation), and ``init_params`` gives every leaf its spec's
    shape and dtype at the reduced size."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    for name in ("gelu", "gelu_tanh", "relu2", "silu"):
        want = np.asarray(jcommon.activation(name)(jnp.asarray(x)))
        np.testing.assert_allclose(_f32(pcommon.activation(name)(_t(x))),
                                   want, rtol=1e-6, atol=1e-6, err_msg=name)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    assert np.abs(exact - np.asarray(jax.nn.gelu(jnp.asarray(x)))).max() \
        > 1e-5
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e5):
        want = np.asarray(jcommon.rope(jnp.asarray(x), jnp.asarray(pos),
                                       theta))
        np.testing.assert_allclose(_f32(pcommon.rope(_t(x), _t(pos), theta)),
                                   want, rtol=1e-5, atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _f32(pcommon.rms_norm(_t(x), _t(scale))),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-6)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7)).astype(np.int32)
    assert np.array_equal(_f32(pcommon.embed_lookup(_t(table), _t(tok))),
                          table[tok])
    for arch_id in PA.list_archs():
        assert PA.count_total_params(PA.get_arch(arch_id)) \
            == RA.count_total_params(RA.get_arch(arch_id)), arch_id
    assert PA.count_total_params(PA.get_arch("minitron_4b")) \
        == 4_190_309_376
    spec = pconfigs.reduced_arch("starcoder2_7b")
    specs = PA.param_specs(spec)
    params = pcommon.init_params(torch.Generator().manual_seed(0), specs)
    got = [s.shape for s in pcommon.spec_leaves(specs)]
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key])
        elif isinstance(t, list):
            for item in t:
                walk(item)
        else:
            leaves.append(t)
    walk(params)
    assert [tuple(t.shape) for t in leaves] == got
    assert all(t.dtype == torch.bfloat16 for t in leaves)
    assert torch.equal(params["blocks"][0]["attn"]["bq"],
                       torch.zeros_like(params["blocks"][0]["attn"]["bq"]))


def test_params_from_reference_is_exact_on_bf16_leaves():
    """The JAX package's bf16 leaves come out of ``np.asarray`` as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects;
    ``params_from_reference`` goes through f32 and is exact, with the
    stacked blocks unstacked per layer."""
    spec = ref_reduced_arch("minitron_4b")
    params = jax.tree.map(np.asarray, jcommon.init_params(
        jax.random.PRNGKey(0), RA.param_specs(spec)))
    with pytest.raises(TypeError):
        torch.from_numpy(np.array(params["embed"]))
    port = ptf.params_from_reference(params, device="cpu")
    assert len(port["blocks"]) == spec.cfg.n_layers
    pairs = [(port["embed"], params["embed"]), (port["head"], params["head"]),
             (port["ln_final"], params["ln_final"])]
    for i, layer in enumerate(port["blocks"]):
        pairs += [(layer["attn"][n], params["blocks"]["attn"][n][i])
                  for n in ("wq", "wk", "wv", "wo")]
        pairs += [(layer["mlp"][n], params["blocks"]["mlp"][n][i])
                  for n in ("w_up", "w_down")]
        pairs += [(layer[n], params["blocks"][n][i])
                  for n in ("ln_attn", "ln_mlp")]
    for got, want in pairs:
        assert got.dtype == torch.bfloat16
        assert np.array_equal(_f32(got), want.astype(np.float32))


# ---------------------------------------------------------------------------
# decode parity: reduced configs, teacher-forced against the JAX package
# ---------------------------------------------------------------------------

PROMPT, STEPS, MAX_LEN, ROWS = 8, 8, 32, 2


# XLA:CPU by default drops bf16 -> f32 round trips inside a fusion (excess
# precision), so a jitted bf16 program rounds at fewer places than its
# eager ops do: on reduced minitron_4b its prefill logits moved by up to
# 0.032 from the op-by-op values.  Compiled without it, the reference
# rounds where its code says, as the port's eager ops do (the two
# prefills then agree bitwise on that case).
EXACT_BF16 = {"xla_allow_excess_precision": False}


@pytest.fixture(scope="module")
def references():
    """One jitted prefill and one jitted decode per reduced config (each
    compiles once per parameter dtype), with the config's bf16 params."""
    out = {}
    for arch_id in ("minitron_4b", "starcoder2_7b"):
        spec = ref_reduced_arch(arch_id)
        out[arch_id] = dict(
            spec=spec,
            params=jcommon.init_params(jax.random.PRNGKey(0),
                                       RA.param_specs(spec)),
            prefill=jax.jit(RA.make_prefill(spec, MAX_LEN),
                            compiler_options=EXACT_BF16),
            decode=jax.jit(RA.make_decode(spec),
                           compiler_options=EXACT_BF16))
    return out


def _cast_weights_decode(q, k_cache, v_cache, lengths):
    """The JAX package's decode attention: ``decode_attention_ref`` with
    the softmax weights cast to the cache dtype before the value product
    (``models/attention.py:336``)."""
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    s = torch.einsum("bhgd,bshd->bhgs",
                     q.to(torch.float32).reshape(B, KH, H // KH, Dh),
                     k_cache.to(torch.float32)) / np.sqrt(Dh)
    valid = torch.arange(S)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(v_cache.dtype).to(torch.float32)
    out = torch.einsum("bhgs,bshd->bhgd", w, v_cache.to(torch.float32))
    return out.reshape(B, H, Dh).to(q.dtype)


def _teacher_forced(ref, params, spec):
    """Per step (prefill, then STEPS decodes on the JAX package's greedy
    tokens): (the JAX package's logits, the port's), as f32 numpy."""
    port_params = ptf.params_from_reference(params, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, spec.cfg.vocab, (ROWS, PROMPT)).astype(np.int32)
    positions = np.broadcast_to(np.arange(PROMPT, dtype=np.int32),
                                (ROWS, PROMPT)).copy()
    j_logits, j_cache = ref["prefill"](
        params, {"tokens": jnp.asarray(tokens),
                 "positions": jnp.asarray(positions)})
    p_logits, p_cache = PA.make_prefill(spec, MAX_LEN)(
        port_params, {"tokens": _t(tokens), "positions": _t(positions)})
    decode = PA.make_decode(spec)
    out = []
    for step in range(STEPS + 1):
        want = np.asarray(j_logits, np.float32)
        out.append((want, _f32(p_logits)))
        if step == STEPS:
            return out
        tok = np.argmax(want, axis=-1).astype(np.int32)
        pos = np.full(ROWS, PROMPT + step, np.int32)
        j_logits, j_cache = ref["decode"](
            params, j_cache, {"token": jnp.asarray(tok),
                              "position": jnp.asarray(pos)})
        p_logits, p_cache = decode(port_params, p_cache,
                                   {"token": _t(tok), "position": _t(pos)})


@pytest.mark.parametrize("arch_id", ["minitron_4b", "starcoder2_7b"])
def test_decode_matches_reference_teacher_forced(references, arch_id,
                                                 monkeypatch):
    """f32 parameters: logits allclose at 1e-4 and greedy tokens equal
    wherever the JAX package's top-2 gap exceeds 1e-3.  bf16 parameters:
    logits within 2e-2 relative and 2e-2 of the step's largest logit
    (the rounding differences sit in the hidden state, so their size
    follows the logits' scale, not each logit's: on these cases up to
    0.047 at logits of 3-4, where 2e-2 absolute failed on 0.5% of the
    entries); and on minitron_4b, with the JAX package's softmax-weight
    cast put into the port's plain decode attention, bitwise equal at
    every step — the cast is the only difference there.  (starcoder2_7b's
    gelu rounds once in torch and after each op in the JAX package.)"""
    ref = references[arch_id]
    spec = pconfigs.reduced_arch(arch_id)
    assert spec.cfg == ptf.TransformerConfig(**{
        f: getattr(ref["spec"].cfg, f)
        for f in ptf.TransformerConfig.__dataclass_fields__})
    params = ref["params"]
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    for step, (want, got) in enumerate(_teacher_forced(ref, f32, spec)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"f32, step {step}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        assert np.array_equal(np.argmax(got, axis=-1)[clear],
                              np.argmax(want, axis=-1)[clear])
    for step, (want, got) in enumerate(_teacher_forced(ref, params, spec)):
        np.testing.assert_allclose(
            got, want, rtol=TOL["bfloat16"],
            atol=TOL["bfloat16"] * np.abs(want).max(),
            err_msg=f"bf16, step {step}")
    if arch_id == "minitron_4b":
        monkeypatch.setattr(pfd, "flash_decode_plain", _cast_weights_decode)
        for step, (want, got) in enumerate(
                _teacher_forced(ref, params, spec)):
            assert np.array_equal(got, want), f"step {step}"


# ---------------------------------------------------------------------------
# BatchedDecoder within the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decoder_setup():
    spec = pconfigs.reduced_arch("minitron_4b")
    params = pcommon.init_params(torch.Generator().manual_seed(0),
                                 PA.param_specs(spec))
    return spec, params


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in lengths]


def test_batched_decoder_batched_equals_sequential(decoder_setup):
    """Greedy generations are identical whether a request runs alone or
    co-batched with others, bitwise (following
    tests/test_serve_engine.py::test_batched_equals_sequential); more
    requests than slots all complete."""
    spec, params = decoder_setup
    dec = pserve.BatchedDecoder(spec, params, batch_slots=3, max_len=64,
                                device="cpu")
    prompts = _prompts(dec.vocab, (5, 9, 7, 6), seed=1)
    solo = []
    for p in prompts:
        [r] = dec.run([pserve.Request(prompt=p.copy(), max_new=8)])
        solo.append(list(r.generated))
    reqs = [pserve.Request(prompt=p.copy(), max_new=8, rid=i)
            for i, p in enumerate(prompts)]
    done = sorted(dec.run(reqs), key=lambda r: r.rid)
    assert [list(r.generated) for r in done] == solo
    assert all(len(g) == 8 for g in solo)
    reqs = [pserve.Request(prompt=p, max_new=4, rid=i) for i, p in
            enumerate(_prompts(dec.vocab, [4] * 7, seed=2))]
    done = dec.run(reqs)
    assert sorted(r.rid for r in done) == list(range(7))
    assert all(len(r.generated) == 4 for r in done)
    assert dec.free_slots == 3


def test_batched_decoder_slot_semantics_and_hand_loop(decoder_setup):
    """``max_new == 1`` finishes at admission and never takes a slot; it
    surfaces from the next step, and ``evict_all`` drains live slots and
    admission finishers alike.  Then the decoder's tokens equal a hand
    loop of the port's own prefill and decode_step at the same batch (one
    slot), request after request through the same slot."""
    spec, params = decoder_setup
    dec = pserve.BatchedDecoder(spec, params, batch_slots=2, max_len=64,
                                device="cpu")
    p1, p2, p3 = _prompts(dec.vocab, (5, 6, 7), seed=3)
    one = pserve.Request(prompt=p1, max_new=1, rid=0)
    assert dec.admit(one) and dec.free_slots == 2
    steps = dec.steps
    assert dec.step() == [one] and dec.steps == steps
    assert len(one.generated) == 1
    long_ = pserve.Request(prompt=p2, max_new=5, rid=1)
    again = pserve.Request(prompt=p3, max_new=1, rid=2)
    assert dec.admit(long_) and dec.admit(again) and dec.free_slots == 1
    assert sorted(r.rid for r in dec.evict_all()) == [1, 2]
    assert dec.free_slots == 2 and dec.step() == []
    [r] = dec.run([pserve.Request(prompt=p1, max_new=1, rid=3)])
    assert r.generated == one.generated

    dec = pserve.BatchedDecoder(spec, params, batch_slots=1, max_len=32,
                                device="cpu")
    prompts = _prompts(dec.vocab, (6, 11), seed=4)
    done = dec.run([pserve.Request(prompt=p, max_new=6, rid=i)
                    for i, p in enumerate(prompts)])
    assert dec.steps == 10
    for r, p in zip(sorted(done, key=lambda r: r.rid), prompts):
        S = p.shape[0]
        logits, cache = ptf.prefill(
            params, _t(p[None].astype(np.int64)),
            torch.arange(S, dtype=torch.int32)[None], spec.cfg, 32)
        toks = [int(torch.argmax(logits[0]))]
        for step in range(5):
            logits, cache = ptf.decode_step(
                params, cache, torch.tensor([toks[-1]]),
                torch.tensor([S + step], dtype=torch.int32), spec.cfg)
            toks.append(int(torch.argmax(logits[0])))
        assert r.generated == toks


# ---------------------------------------------------------------------------
# ROADMAP C6: per-call search parameters reach the index
# ---------------------------------------------------------------------------

def _graph_case(N=800, D=12, Q=48, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (N, D)).astype(np.float32)
    ls = pcore.generate_label_sets(N, pcore.LabelWorkloadConfig(
        num_labels=6, seed=2))
    qv = rng.integers(-3, 4, (Q, D)).astype(np.float32)
    qls = pcore.generate_query_label_sets(ls, Q - 1, seed=5,
                                          from_base_fraction=0.75) + [()]
    return x, ls, qv, qls


def test_engine_search_params():
    """``ef`` and ``strategy`` reach each graph index through ``search``,
    ``search_batched``, ``search_looped``, ``warmup`` and
    ``warmup_serving``: the engine's results equal the per-index
    ``search_padded`` calls with the same parameters, a non-default
    ``ef`` changes some query's result, and batched ≡ looped.  A flat
    engine raises the JAX package's ``TypeError`` from each of them."""
    x, ls, qv, qls = _graph_case()
    eng = PortEngine.build(x, ls, mode="eis", c=0.2, backend="graph", M=8,
                           n_cand=16, ef_search=32, device="cpu")
    k, n = 5, len(ls)
    assert eng.warmup([k], [1, 8], ef=8, strategy="pre")["programs"] > 0
    assert eng.warmup_serving([k], 1, 8, ef=8)["programs"] > 0
    qwords = pcore.masks_to_int32_words(pcore.encode_many(qls))
    routed = eng.route_many(qls)
    runs = {}
    for params in ({}, {"ef": 5}, {"ef": 64, "strategy": "pre"}):
        d, i = eng.search(qv, qls, k, **params)
        bd, bi = eng.search_batched(qv, qls, k, min_bucket=4, **params)
        ld, li = eng.search_looped(qv, qls, k, **params)
        np.testing.assert_array_equal(bi, li)
        np.testing.assert_array_equal(bd, ld)
        np.testing.assert_array_equal(i, li)
        for key in set(routed):
            qids = [q for q, r in enumerate(routed) if r == key]
            bucket = 1 << (len(qids) - 1).bit_length()
            qp = np.zeros((bucket, qv.shape[1]), np.float32)
            qp[:len(qids)] = qv[qids]
            lp = np.zeros((bucket, qwords.shape[1]), np.int32)
            lp[:len(qids)] = qwords[qids]
            pd, pl = eng.indexes[key].search_padded(qp, lp, k, **params)
            rows = eng.rows[key]
            pl = pl[:len(qids)].numpy()
            gi = np.where(pl >= rows.size, n,
                          rows[np.clip(pl, 0, rows.size - 1)])
            np.testing.assert_array_equal(i[qids], gi, err_msg=str(params))
            np.testing.assert_array_equal(d[qids],
                                          pd[:len(qids)].numpy())
        runs[tuple(sorted(params.items()))] = i
    assert not np.array_equal(runs[()], runs[(("ef", 5),)])

    x, ls, qv, qls = _graph_case(N=300)
    eng = PortEngine.build(x, ls, mode="eis", c=0.2, backend="flat",
                           device="cpu")
    msg = r"arena-native backend 'flat' takes no search params; got \['ef'\]"
    for call in (lambda: eng.search(qv, qls, 5, ef=32),
                 lambda: eng.search_batched(qv, qls, 5, ef=32),
                 lambda: eng.search_looped(qv, qls, 5, ef=32),
                 lambda: eng.warmup([5], [8], ef=32),
                 lambda: eng.warmup_serving([5], 1, 8, ef=32)):
        with pytest.raises(TypeError, match=msg):
            call()
    d, i = eng.search(qv, qls, 5)
    assert i.shape == (len(qls), 5)
