"""The port's quantized KV pages (int8 and fp8) against the JAX package's.

Every input is made from a numpy seed and goes through both sides; the
JAX kernels run in interpret mode on the CPU, as the JAX package's own
tests run them (tests/test_kv_quant.py), and the port runs its kernels'
plain versions (CPU tensors). Each test runs for int8 and for fp8.
Tolerances, each with its reason:
- quantize and dequantize, and the page write: bit-equal (the same f32
  arithmetic, IEEE division and round-half-even on both sides);
- decode and paged prefill attention, f32: atol=rtol=2e-5 (sums taken in
  another order);
- the forward's logits: 1e-4; its pools' narrow bytes equal after every
  step, their scales within SCALE_RTOL.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import JaxEngine
from dynamo_tpu.engine.request import SamplingParams as JaxSampling
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops.flash_prefill import paged_prefill_attention as jax_paged_prefill
from dynamo_tpu.ops.kv_update import paged_write as jax_paged_write
from dynamo_tpu.ops.paged_attention import paged_decode_attention as jax_paged_decode
from dynamo_tpu_torch import ops
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import TorchEngine
from dynamo_tpu_torch.engine.request import SamplingParams
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import flash_prefill, kv_update, paged_attention
from helpers.torch_write_cases import write_params

MODES = ("int8", "fp8")
TOL = dict(atol=2e-5, rtol=2e-5)
ATOL = 1e-4
#: the forward's scale planes: the two sides' f32 matmuls sum in another
#: order, so a staged K/V value may differ by a few f32 ulps, and a row's
#: scale (its amax / qmax) by as much (measured: under 8e-7)
SCALE_RTOL = 2e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _bytes(x) -> np.ndarray:
    """A narrow array's bytes (JAX or torch), to compare bit for bit."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 and x.dtype != np.int8 else x


def _jax_rows(raw: np.ndarray, mode: str):
    """Narrow rows given as int8 (int8) or uint8 bytes (fp8) as a JAX array."""
    if mode == "int8":
        return jnp.asarray(raw)
    return jax.lax.bitcast_convert_type(jnp.asarray(raw), jnp.float8_e4m3fn)


def _torch_rows(raw: np.ndarray, mode: str) -> torch.Tensor:
    t = _t(raw)
    return t if mode == "int8" else t.view(torch.float8_e4m3fn)


def _quantized_pool(rng, shape, mode):
    """Random pool contents: rows quantized from normals, with their scales
    (the bytes as numpy, int8 or uint8, and the f32 planes)."""
    q, s = jllama.quantize_kv_rows(
        jnp.asarray(rng.standard_normal(shape) * rng.uniform(0.1, 4.0, shape[:-1] + (1,)),
                    jnp.float32), mode)
    return _bytes(q).copy(), np.asarray(s).copy()


# -- quantize and dequantize ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_quantize_rows_bit_equal_to_jax(mode, dtype):
    """Rows of many magnitudes (down to the 1e-8 scale floor), a zero row,
    and rows whose largest element is +amax or -amax, so that it maps to
    +qmax or -qmax."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 9, 2, 64)) * 10.0 ** rng.uniform(-9, 2, (6, 9, 2, 1))
    x[0, 0, 0] = 0.0
    x[0, 1, 0, 5] = 50.0   # +amax -> +qmax
    x[0, 2, 1, 7] = -50.0  # -amax -> -qmax
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jllama.quantize_kv_rows(jx, mode)
    tq, ts = tllama.quantize_kv_rows(tx, mode)
    assert tq.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    qmax = tllama.kv_quant_spec(mode)[1]
    assert tq[0, 1, 0, 5].float() == qmax and tq[0, 2, 1, 7].float() == -qmax
    assert (tq[0, 0, 0].float() == 0).all() and ts[0, 0, 0] == 1e-8
    for out in (torch.float32, torch.bfloat16):
        jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[out]
        np.testing.assert_array_equal(
            tllama.dequantize_kv_rows(tq, ts, out).float().numpy(),
            np.asarray(jllama.dequantize_kv_rows(jq, js, jdt).astype(jnp.float32)),
        )


def test_quant_spec_refuses_other_modes():
    with pytest.raises(ValueError, match="int4"):
        tllama.kv_quant_spec("int4")


@pytest.mark.parametrize("mode", [None, *MODES])
def test_kv_page_bytes_equals_jax(mode):
    """At llama3-8b, whose head_dim 128 is also the JAX package's lane-padded
    kv_head_dim, a page costs what the JAX function says: D narrow bytes
    and a 4-byte scale per row, or D model-dtype values."""
    jcfg, tcfg = jllama.LlamaConfig.llama3_8b(), tllama.LlamaConfig.llama3_8b()
    assert jcfg.kv_head_dim == tcfg.head_dim == 128
    assert tllama.kv_page_bytes(tcfg, 64, mode) == jllama.kv_page_bytes(jcfg, 64, mode)


# -- the page write ---------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("b,t,s,valid_rows,hkv", write_params())
def test_quantized_paged_write_byte_equal_to_jax(b, t, s, valid_rows, hkv, mode):
    """The plain write over a quantized pool against the JAX
    paged_write(use_kernel=True) (Pallas in interpret mode): rows and scale
    planes byte-equal on every page but the null page 0 (both land whole
    runs, padding tails included), at Hkv 1, 2 and 8."""
    rng = np.random.default_rng(31 * b + t)
    L, d = 2, 128
    mp = max(4, -(-t // s))
    P = max(16, 1 + b * mp)
    k_raw, k_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    v_raw, v_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    k_stage = rng.standard_normal((L, b, t, hkv, d)).astype(np.float32)
    v_stage = (3 * rng.standard_normal((L, b, t, hkv, d))).astype(np.float32)
    pt = (1 + rng.permutation(P - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    if t == 1:
        positions = rng.integers(0, mp * s, (b, 1)).astype(np.int32)
        valid = np.asarray(valid_rows, bool)[:, None]
    else:
        positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
        valid = positions < np.asarray(valid_rows)[:, None]
    want = jax_paged_write(
        _jax_rows(k_raw, mode), _jax_rows(v_raw, mode), jnp.asarray(k_stage),
        jnp.asarray(v_stage), jnp.asarray(pt), jnp.asarray(positions), jnp.asarray(valid),
        use_kernel=True, k_scale=jnp.asarray(k_sc), v_scale=jnp.asarray(v_sc),
    )
    ops.reset_counts()
    got = kv_update.paged_write(
        _torch_rows(k_raw.copy(), mode), _torch_rows(v_raw.copy(), mode), _t(k_stage),
        _t(v_stage), _t(pt), _t(positions), _t(valid),
        k_scale=_t(k_sc.copy()), v_scale=_t(v_sc.copy()),
    )
    assert len(got) == 4
    for g, w in zip(got, want):  # k, v, k_scale, v_scale
        np.testing.assert_array_equal(_bytes(g)[:, 1:], _bytes(w)[:, 1:])
    # padding lanes never touch a real page
    for i, rows in enumerate(valid_rows):
        if rows == 0:
            np.testing.assert_array_equal(_bytes(got[0])[:, pt[i]], k_raw[:, pt[i]])
            np.testing.assert_array_equal(got[2].numpy()[:, pt[i]], k_sc[:, pt[i]])
    c = ops.COUNTS[f"paged_write.{mode}"]
    assert (c.launches, c.plain_calls) == (0, 1)
    assert ops.COUNTS["paged_write"].plain_calls == 0


def test_wrappers_refuse_a_pool_without_its_scales_or_scales_without_a_narrow_pool():
    pool = torch.zeros((1, 2, 4, 1, 64), dtype=torch.int8)
    stage = torch.zeros((1, 1, 1, 1, 64))
    args = (torch.ones((1, 1), dtype=torch.int32), torch.zeros((1, 1), dtype=torch.int32),
            torch.ones((1, 1), dtype=torch.bool))
    with pytest.raises(ValueError, match="scale planes"):
        kv_update.paged_write(pool, pool, stage, stage, *args)
    planes = torch.zeros((1, 2, 4, 1))
    with pytest.raises(ValueError, match="int8 or float8_e4m3fn"):
        kv_update.paged_write(pool.float(), pool.float(), stage, stage, *args,
                              k_scale=planes, v_scale=planes)
    with pytest.raises(ValueError, match="together"):
        kv_update.paged_write(pool, pool, stage, stage, *args, k_scale=planes)


# -- the readers ------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "hq,hkv,hist",
    [
        (4, 4, (0, 5, 16, 3)),    # g=1: zero history, partial and full pages
        (8, 2, (7, 0, 13, 1)),    # g=4
    ],
)
def test_quantized_paged_decode_plain_matches_jax(hq, hkv, hist, mode):
    L, P, s, d, mp = 3, 24, 4, 128, 4
    b = len(hist)
    rng = np.random.default_rng(hq + 7 * hkv + len(mode))
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k_raw, k_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    v_raw, v_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    pt = (1 + rng.permutation(P - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    hist_lens = np.asarray(hist, np.int32)
    layer = 1
    racc, rm, rl = (
        np.asarray(x)
        for x in jax_paged_decode(
            jnp.asarray(q), _jax_rows(k_raw, mode), _jax_rows(v_raw, mode),
            jnp.int32(layer), jnp.asarray(pt), jnp.asarray(hist_lens), scale_dim=d,
            interpret=True, k_scale=jnp.asarray(k_sc), v_scale=jnp.asarray(v_sc),
        )
    )
    ops.reset_counts()
    acc, m, l = paged_attention.paged_decode_attention(
        _t(q), _torch_rows(k_raw, mode), _torch_rows(v_raw, mode), layer, _t(pt),
        _t(hist_lens), scale_dim=d, k_scale=_t(k_sc), v_scale=_t(v_sc),
    )
    np.testing.assert_allclose(acc.numpy(), racc, **TOL)
    np.testing.assert_allclose(m.numpy(), rm, **TOL)
    np.testing.assert_allclose(l.numpy(), rl, **TOL)
    empty = hist_lens == 0
    assert (acc.numpy()[empty] == 0).all() and (l.numpy()[empty] == 0).all()
    assert np.isneginf(m.numpy()[empty]).all()
    assert ops.COUNTS[f"paged_decode_attention.{mode}"].plain_calls == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "b,t,hq,hkv,d,hist,cur",
    [
        (2, 128, 4, 2, 128, (128, 65), (128, 90)),     # full chunk beside a ragged one
        (3, 64, 4, 1, 128, (65, 0, 130), (64, 33, 1)),  # partial last pages, a first chunk
        (2, 128, 8, 2, 64, (100, 64), (128, 77)),      # D=64, GQA g=4
    ],
)
def test_quantized_paged_prefill_plain_matches_jax(b, t, hq, hkv, d, hist, cur, mode):
    _quantized_paged_prefill_case(b, t, hq, hkv, d, hist, cur, mode, s=64, num_pages=16, mp=4)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "s,num_pages,mp,b,t,hist,cur",
    [
        (16, 24, 10, 2, 64, (150, 37), (64, 50)),  # many pages, a history ending mid-page
        (128, 6, 2, 2, 64, (100, 200), (64, 33)),  # inside one page, over two
    ],
)
def test_quantized_paged_prefill_plain_matches_jax_page_sizes(s, num_pages, mp, b, t, hist,
                                                              cur, mode):
    """Page sizes smaller and larger than 64 (the CUDA kernel's key tile)
    over quantized pools: the plain version against the Pallas kernel in
    interpret mode, GQA g=2 at D=64."""
    _quantized_paged_prefill_case(b, t, 4, 2, 64, hist, cur, mode, s=s,
                                  num_pages=num_pages, mp=mp)


def _quantized_paged_prefill_case(b, t, hq, hkv, d, hist, cur, mode, *, s, num_pages, mp):
    """One paged prefill case over a quantized pool of `num_pages` pages of
    `s` slots, through the Pallas kernel (interpret mode) and the port's
    plain version."""
    layers, layer = 2, 1
    rng = np.random.default_rng(1000 * b + t + d + len(mode) + (0 if s == 64 else s))
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    kc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    k_raw, k_sc = _quantized_pool(rng, (layers, num_pages, s, hkv, d), mode)
    v_raw, v_sc = _quantized_pool(rng, (layers, num_pages, s, hkv, d), mode)
    pt = (1 + rng.permutation(num_pages - 1)[: b * mp]).reshape(b, mp).astype(np.int32)
    hist_lens = np.asarray(hist, np.int32)
    cur_lens = np.asarray(cur, np.int32)
    ref = np.asarray(
        jax_paged_prefill(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), _jax_rows(k_raw, mode),
            _jax_rows(v_raw, mode), jnp.int32(layer), jnp.asarray(pt),
            jnp.asarray(hist_lens), jnp.asarray(cur_lens), scale_dim=d, interpret=True,
            k_scale=jnp.asarray(k_sc), v_scale=jnp.asarray(v_sc),
        )
    )
    ops.reset_counts()
    got = flash_prefill.paged_prefill_attention(
        _t(q), _t(kc), _t(vc), _torch_rows(k_raw, mode), _torch_rows(v_raw, mode), layer,
        _t(pt), _t(hist_lens), _t(cur_lens), scale_dim=d, k_scale=_t(k_sc),
        v_scale=_t(v_sc),
    ).numpy()
    assert np.isfinite(got).all()
    for i, n in enumerate(cur):  # rows at or past cur_lens are unspecified
        np.testing.assert_allclose(got[i, :n], ref[i, :n], **TOL)
    c = ops.COUNTS[f"paged_prefill_attention.{mode}"]
    assert (c.launches, c.plain_calls) == (0, 1)


@pytest.mark.parametrize("mode", MODES)
def test_readers_select_masked_slots_and_never_multiply_them(mode):
    """Slots past each history hold bytes that may encode NaN (fp8 0x7f;
    int8 has none, so its case holds the finite stale byte -128) and zero
    scales: both readers give exactly what they give over a clean pool,
    because masked slots are selected away, never multiplied by a zero."""
    rng = np.random.default_rng(5)
    L, P, s, hkv, d, mp, hq, t = 2, 12, 4, 2, 64, 3, 4, 8
    k_raw, k_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    v_raw, v_sc = _quantized_pool(rng, (L, P, s, hkv, d), mode)
    pt = (1 + rng.permutation(P - 1)[: 2 * mp]).reshape(2, mp).astype(np.int32)
    hist = np.asarray([5, 9], np.int32)
    dirty = [x.copy() for x in (k_raw, v_raw, k_sc, v_sc)]
    for i, n in enumerate(hist):
        for slot in range(n, mp * s):
            page = pt[i, slot // s]
            dirty[0][:, page, slot % s] = dirty[1][:, page, slot % s] = (
                0x7F if mode == "fp8" else -128)
            dirty[2][:, page, slot % s] = dirty[3][:, page, slot % s] = 0.0
    q = _t(rng.standard_normal((2, hq, d)).astype(np.float32))
    qp = _t(rng.standard_normal((2, t, hq, d)).astype(np.float32))
    cur = _t(rng.standard_normal((2, t, hkv, d)).astype(np.float32))
    lens = _t(np.asarray([t, t], np.int32))
    outs = []
    for kr, vr, ks, vs in ((k_raw, v_raw, k_sc, v_sc), dirty):
        pools = (_torch_rows(kr, mode), _torch_rows(vr, mode))
        planes = dict(k_scale=_t(ks), v_scale=_t(vs))
        dec = paged_attention.paged_decode_attention(q, *pools, 1, _t(pt), _t(hist), **planes)
        pre = flash_prefill.paged_prefill_attention(
            qp, cur, cur, *pools, 1, _t(pt), _t(hist), lens, **planes)
        outs.append((*dec, pre))
    for clean, stale in zip(*outs):
        assert torch.isfinite(stale).all()
        assert torch.equal(clean, stale)


# -- the forward ------------------------------------------------------------------


def _chunked_forward_pair(mode):
    """tests/test_kv_quant.py::_chunked_forward on both sides: B=2, a first
    chunk of 8, a chunk of 8 with history, then 4 decode steps, each over
    its own quantized pool. Yields (step, port logits, JAX logits, port
    pool, JAX pool, port config, page tables) after every step."""
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), attention_impl="pallas")
    tcfg = tllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jax.random.key(0), jcfg)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(1, 200, (2, 16)).astype(np.int32)
    b, t, s = 2, 8, 4
    pt = np.stack([np.arange(1, 9), np.arange(9, 17)]).astype(np.int32)
    jkv = jllama.init_kv_pages(jcfg, 32, s, kv_quantize=mode)
    tkv = tllama.init_kv_pages(tcfg, 32, s, "cpu", kv_quantize=mode)
    pos1 = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    steps = [(toks[:, :t], pos1, True), (toks[:, t:], pos1 + t, False)]
    steps += [(np.asarray([[3], [4]], np.int32), np.full((b, 1), 2 * t + i, np.int32), False)
              for i in range(4)]
    for i, (tok, pos, first) in enumerate(steps):
        valid = np.ones(tok.shape, bool)
        jl, jkv = jllama.forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(valid), jkv, jnp.asarray(pt), first_chunk=first)
        tl, tkv = tllama.forward(tparams, tcfg, _t(tok).long(), _t(pos), _t(valid), tkv,
                                 _t(pt), first_chunk=first)
        yield i, tl.numpy(), np.asarray(jl), tkv, jkv, tcfg, pt


@pytest.mark.parametrize("mode", MODES)
def test_quantized_forward_matches_jax_forward(mode):
    """The JAX forward with attention_impl="pallas" and the same kv_quantize
    (params and pools carried across): a first chunk, a chunk with
    history, then 4 decode steps. Logits agree within 1e-4 at every step;
    after every step the pools hold the same narrow bytes on every written
    slot, and scales within SCALE_RTOL (the JAX pool carried across with
    kv_pages_from_jax)."""
    ops.reset_counts()
    for step, tl, jl, tkv, jkv, tcfg, pt in _chunked_forward_pair(mode):
        np.testing.assert_allclose(tl, jl, atol=ATOL, err_msg=f"step {step}")
        ref = tllama.kv_pages_from_jax(
            _bytes(jkv.k), _bytes(jkv.v), tcfg, device="cpu",
            k_scale=np.asarray(jkv.k_scale), v_scale=np.asarray(jkv.v_scale))
        written = 8 if step == 0 else 16 + max(0, step - 1)
        pos = np.arange(written)
        for i in range(2):
            pages, slots = pt[i, pos // 4], pos % 4
            for got, want in ((tkv.k, ref.k), (tkv.v, ref.v)):
                np.testing.assert_array_equal(_bytes(got[:, pages, slots]),
                                              _bytes(want[:, pages, slots]))
            for got, want in ((tkv.k_scale, ref.k_scale), (tkv.v_scale, ref.v_scale)):
                np.testing.assert_allclose(got[:, pages, slots].numpy(),
                                           want[:, pages, slots].numpy(), rtol=SCALE_RTOL)
    layers = tcfg.num_layers
    assert ops.COUNTS[f"paged_write.{mode}"].plain_calls == 6
    assert ops.COUNTS[f"paged_prefill_attention.{mode}"].plain_calls == layers
    assert ops.COUNTS[f"paged_decode_attention.{mode}"].plain_calls == 4 * layers
    assert ops.COUNTS["flash_prefill_attention"].plain_calls == layers
    assert all(ops.COUNTS[n].plain_calls == 0 for n in
               ("paged_write", "paged_prefill_attention", "paged_decode_attention"))


# -- the engine -------------------------------------------------------------------

PROMPTS = {
    "a": [5, 17, 42, 9, 3, 7, 11, 2],
    "b": list(range(1, 17)),  # exactly one chunk
    "c": [200],
    **{f"p{n}": np.random.default_rng(n).integers(1, 256, n).tolist() for n in (17, 33, 47)},
}
MAX_TOKENS = {"a": 9, "b": 6, "c": 12, "p17": 5, "p33": 4, "p47": 3}


def _engines(mode, decode_steps):
    jax_eng = JaxEngine(JaxEngineConfig.for_tests(
        attention_impl="pallas", enable_prefix_caching=False, overlap_decode=False,
        mixed_steps=False, kv_quantize=mode, decode_steps=decode_steps, max_pages_per_seq=16,
    ))
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jax_eng.params), tllama.LlamaConfig.tiny(), device="cpu")
    cfg = EngineConfig.for_tests(kv_quantize=mode, decode_steps=decode_steps,
                                 max_pages_per_seq=16, enable_prefix_caching=False,
                                 mixed_steps=False)
    return jax_eng, lambda: TorchEngine(cfg, params=params, device="cpu")


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_int8_greedy_streams_identical_to_jax_engine(decode_steps):
    """Prompts of one chunk (prefill_chunk=16) and of two to three; the
    port's streams equal JaxEngine's, and two runs of the port are
    identical."""
    jax_eng, make = _engines("int8", decode_steps)
    runs = []
    for eng, sampling in ((jax_eng, JaxSampling), (make(), SamplingParams), (make(), SamplingParams)):
        for rid, prompt in PROMPTS.items():
            eng.add_request(rid, prompt, sampling(max_tokens=MAX_TOKENS[rid], ignore_eos=True))
        runs.append(eng.run_to_completion())
    want, got, again = runs
    assert got == want
    assert again == got
    assert {rid: len(t) for rid, t in got.items()} == MAX_TOKENS


@pytest.mark.parametrize("mode", MODES)
def test_pool_gauges_equal_the_real_tensors_bytes(mode):
    """kv_pool_bytes counts the pools and their scale planes as allocated;
    kv_pool_bytes_dense_equiv what the same rows cost in the model dtype.
    At the tiny config (f32, D=16) their ratio is (16 + 4) / 64, as the JAX
    engine reports it."""
    eng = TorchEngine(EngineConfig.for_tests(kv_quantize=mode), device="cpu")
    kv = eng.kv
    assert kv.quantized and kv.k_scale.shape == kv.k.shape[:-1]
    real = sum(x.numel() * x.element_size() for x in (kv.k, kv.v, kv.k_scale, kv.v_scale))
    assert eng.metrics.kv_pool_bytes == real
    assert eng.metrics.kv_pool_bytes_dense_equiv == (kv.k.numel() + kv.v.numel()) * 4
    jax_m = JaxEngine(JaxEngineConfig.for_tests(kv_quantize=mode)).metrics
    ratio = eng.metrics.kv_pool_bytes / eng.metrics.kv_pool_bytes_dense_equiv
    assert ratio == jax_m.kv_pool_bytes / jax_m.kv_pool_bytes_dense_equiv == 20 / 64
    dense = TorchEngine(EngineConfig.for_tests(), device="cpu").metrics
    assert dense.kv_pool_bytes == dense.kv_pool_bytes_dense_equiv == real * 64 // 20


@pytest.mark.parametrize("value,ok", [(None, True), ("int8", True), ("fp8", True),
                                      ("int4", False), ("INT8", False)])
def test_engine_config_checks_kv_quantize(value, ok):
    if ok:
        assert EngineConfig.for_tests(kv_quantize=value).kv_quantize == value
    else:
        with pytest.raises(ValueError, match="kv_quantize"):
            EngineConfig.for_tests(kv_quantize=value)
