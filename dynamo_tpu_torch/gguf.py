"""GGUF model files: the reader, the ggml dequantizers and a writer.

Counterpart of dynamo_tpu/gguf.py (numpy and the standard library, so the
port keeps its own copy): GGUF v2/v3 containers are parsed into typed
metadata, the tensor index and tensor data (F32, F16 and BF16 raw, and
Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q4_K, Q5_K and Q6_K dequantized to f32);
the embedded vocabulary, the architecture, the serving config (the
port's LlamaConfig) and the context length come from the metadata.

The header is read from a memory map with `struct.unpack_from`, so a
128k-entry vocabulary parses in a fraction of a second; the last file
parsed is kept, keyed by its path, mtime and size, so a server's start
(its card, config, vocabulary and weights) parses the file once. Raw
tensors are copy-on-write maps of the file, so a load reads each
tensor's bytes once.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)

_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _U64: "<Q", _I64: "<q", _F64: "<d",
}
#: scalar metadata type -> numpy dtype, for arrays read in bulk
_SCALAR_NP = {
    _U8: "<u1", _I8: "<i1", _U16: "<u2", _I16: "<i2", _U32: "<u4", _I32: "<i4",
    _F32: "<f4", _U64: "<u8", _I64: "<i8", _F64: "<f8",
}

#: ggml tensor types read raw (id -> (numpy dtype, bytes an element))
_TENSOR_DTYPES = {
    0: ("float32", 4),  # F32
    1: ("float16", 2),  # F16
    30: ("bfloat16", 2),  # BF16
}

# -- ggml quantized blocks ------------------------------------------------------
# Byte layouts follow the public ggml spec (block structs in ggml-common.h).

#: quantized ggml type id -> (elements a block, bytes a block)
_QUANT_BLOCKS = {
    2: (32, 18),    # Q4_0: f16 d + 16B nibbles
    3: (32, 20),    # Q4_1: f16 d + f16 m + 16B nibbles
    6: (32, 22),    # Q5_0: f16 d + 4B high bits + 16B nibbles
    7: (32, 24),    # Q5_1: f16 d + f16 m + 4B high bits + 16B nibbles
    8: (32, 34),    # Q8_0: f16 d + 32 x i8
    12: (256, 144),  # Q4_K: f16 d + f16 dmin + 12B 6-bit scales + 128B
    13: (256, 176),  # Q5_K: Q4_K + 32B high bits
    14: (256, 210),  # Q6_K: 128B low + 64B high + 16 x i8 scales + f16 d
}


def _f16(raw: np.ndarray) -> np.ndarray:
    return raw.view("<f2").astype(np.float32)


def _dequant_q8_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])  # [N, 1]
    q = b[:, 2:34].view(np.int8).astype(np.float32)
    return d * q


def _dequant_q4_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32) - 8.0
    return d * q


def _dequant_q4_1(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return d * q + m


def _dequant_q5_0(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    qh = b[:, 2:6].copy().view("<u4")  # [N, 1]: 32 high bits
    qs = b[:, 6:22]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1  # [N, 32]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int32)
    q = (q | (bits.astype(np.int32) << 4)).astype(np.float32) - 16.0
    return d * q


def _dequant_q5_1(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qh = b[:, 4:8].copy().view("<u4")
    qs = b[:, 8:24]
    bits = (qh >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int32)
    q = (q | (bits.astype(np.int32) << 4)).astype(np.float32)
    return d * q + m


def _k_scale_min(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q4_K/Q5_K's 12-byte 6-bit scale/min pairs -> ([N, 8], [N, 8])
    (get_scale_min_k4 in ggml)."""
    s = scales.astype(np.uint16)
    sc = np.empty((s.shape[0], 8), np.float32)
    mn = np.empty((s.shape[0], 8), np.float32)
    for j in range(4):
        sc[:, j] = (s[:, j] & 63).astype(np.float32)
        mn[:, j] = (s[:, j + 4] & 63).astype(np.float32)
    for j in range(4, 8):
        sc[:, j] = ((s[:, j + 4] & 0xF) | ((s[:, j - 4] >> 6) << 4)).astype(np.float32)
        mn[:, j] = ((s[:, j + 4] >> 4) | ((s[:, j] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _dequant_q4_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])  # [N, 1]
    dmin = _f16(b[:, 2:4])
    sc, mn = _k_scale_min(b[:, 4:16])  # [N, 8]
    qs = b[:, 16:144]  # [N, 128]: 4 chunks of 32B, low then high nibbles
    out = np.empty((b.shape[0], 256), np.float32)
    for c in range(4):
        chunk = qs[:, c * 32:(c + 1) * 32]
        g_lo, g_hi = 2 * c, 2 * c + 1
        out[:, g_lo * 32:g_lo * 32 + 32] = (
            d * sc[:, g_lo:g_lo + 1] * (chunk & 0xF).astype(np.float32)
            - dmin * mn[:, g_lo:g_lo + 1])
        out[:, g_hi * 32:g_hi * 32 + 32] = (
            d * sc[:, g_hi:g_hi + 1] * (chunk >> 4).astype(np.float32)
            - dmin * mn[:, g_hi:g_hi + 1])
    return out


def _dequant_q5_k(b: np.ndarray) -> np.ndarray:
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k_scale_min(b[:, 4:16])
    qh = b[:, 16:48]  # [N, 32]
    qs = b[:, 48:176]  # [N, 128]
    out = np.empty((b.shape[0], 256), np.float32)
    for c in range(4):
        chunk = qs[:, c * 32:(c + 1) * 32]
        hi_lo = ((qh >> (2 * c)) & 1).astype(np.float32) * 16.0
        hi_hi = ((qh >> (2 * c + 1)) & 1).astype(np.float32) * 16.0
        g_lo, g_hi = 2 * c, 2 * c + 1
        out[:, g_lo * 32:g_lo * 32 + 32] = (
            d * sc[:, g_lo:g_lo + 1] * ((chunk & 0xF).astype(np.float32) + hi_lo)
            - dmin * mn[:, g_lo:g_lo + 1])
        out[:, g_hi * 32:g_hi * 32 + 32] = (
            d * sc[:, g_hi:g_hi + 1] * ((chunk >> 4).astype(np.float32) + hi_hi)
            - dmin * mn[:, g_hi:g_hi + 1])
    return out


def _dequant_q6_k(b: np.ndarray) -> np.ndarray:
    ql = b[:, 0:128]
    qh = b[:, 128:192]  # [N, 64]
    scales = b[:, 192:208].view(np.int8).astype(np.float32)  # [N, 16]
    d = _f16(b[:, 208:210])
    out = np.empty((b.shape[0], 256), np.float32)
    sidx = np.arange(32) // 16  # 16-element sub-blocks: scale l // 16 + 2k
    for half in range(2):  # dequantize_row_q6_K: 128 elements a pass
        qlh = ql[:, half * 64:half * 64 + 64]
        qhh = qh[:, half * 32:half * 32 + 32].astype(np.int32)
        sch = scales[:, half * 8:half * 8 + 8]
        base = half * 128
        for k, (qlow, shift) in enumerate((
            ((qlh[:, 0:32] & 0xF).astype(np.int32), 0),
            ((qlh[:, 32:64] & 0xF).astype(np.int32), 2),
            ((qlh[:, 0:32] >> 4).astype(np.int32), 4),
            ((qlh[:, 32:64] >> 4).astype(np.int32), 6),
        )):
            q = (qlow | (((qhh >> shift) & 3) << 4)).astype(np.float32) - 32.0
            s = sch[:, sidx + 2 * k]  # [N, 32]
            out[:, base + 32 * k:base + 32 * k + 32] = d * s * q
    return out


_DEQUANT_FNS = {
    2: _dequant_q4_0, 3: _dequant_q4_1, 6: _dequant_q5_0, 7: _dequant_q5_1, 8: _dequant_q8_0,
    12: _dequant_q4_k, 13: _dequant_q5_k, 14: _dequant_q6_k,
}


def dequantize(raw, ggml_type: int, count: int) -> np.ndarray:
    """A ggml-quantized tensor's payload (bytes or a buffer) as f32 [count]."""
    if ggml_type not in _QUANT_BLOCKS:
        raise ValueError(f"ggml type {GGML_TYPE_NAMES.get(ggml_type, ggml_type)} has no "
                         "dequantizer")
    elts, nbytes = _QUANT_BLOCKS[ggml_type]
    if count % elts:
        raise ValueError(f"quantized tensor length {count} not a multiple of the "
                         f"{elts}-element block")
    blocks = count // elts
    if len(raw) < blocks * nbytes:
        raise ValueError("quantized tensor data truncated")
    b = np.frombuffer(raw, np.uint8, blocks * nbytes).reshape(blocks, nbytes)
    return _DEQUANT_FNS[ggml_type](b).reshape(-1)


def quantize_q8_0(arr: np.ndarray) -> bytes:
    """Float data packed in Q8_0 blocks (fixtures and export): per 32
    elements an f16 scale d = absmax / 127, then 32 x int8."""
    flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
    if flat.size % 32:
        raise ValueError("Q8_0 needs a multiple of 32 elements")
    blocks = flat.reshape(-1, 32)
    d = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    d = np.maximum(d, 1e-12)
    q = np.clip(np.round(blocks / d), -127, 127).astype(np.int8)
    out = np.empty((blocks.shape[0], 34), np.uint8)
    out[:, 0:2] = d.astype("<f2").view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


#: ggml type id -> name, for messages
GGML_TYPE_NAMES = {
    0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 6: "Q5_0", 7: "Q5_1", 8: "Q8_0", 9: "Q8_1",
    10: "Q2_K", 11: "Q3_K", 12: "Q4_K", 13: "Q5_K", 14: "Q6_K", 15: "Q8_K", 16: "IQ2_XXS",
    24: "I8", 25: "I16", 26: "I32", 27: "I64", 28: "F64", 30: "BF16",
}

#: GGUF architectures whose config the port serves (to_llama_config), and
#: those the reference maps that wait for windows and softcaps in the
#: kernels
_SERVED_ARCHITECTURES = ("llama", "qwen2", "qwen3", "gemma")
_WINDOWED_ARCHITECTURES = ("gemma2", "gemma3")


@dataclass
class GgufTensorInfo:
    name: str
    shape: tuple[int, ...]  # row-major (numpy) order
    ggml_type: int
    offset: int  # from the start of the data section

    @property
    def type_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"type{self.ggml_type}")


@dataclass
class GgufFile:
    path: str
    version: int
    metadata: dict[str, Any]
    tensors: dict[str, GgufTensorInfo]
    data_start: int = 0
    alignment: int = 32

    # -- tensor data ------------------------------------------------------------

    def load_tensor(self, name: str) -> np.ndarray:
        """The tensor in numpy order: F32/F16 as a copy-on-write map of the
        file, BF16 widened to f32, quantized types dequantized to f32."""
        info = self.tensors.get(name)
        if info is None:
            raise KeyError(f"no tensor {name!r} in {self.path}")
        count = int(np.prod(info.shape)) if info.shape else 1
        start = self.data_start + info.offset
        if info.ggml_type in _QUANT_BLOCKS:
            elts, nbytes = _QUANT_BLOCKS[info.ggml_type]
            raw = np.memmap(self.path, np.uint8, "c", start, ((count // elts) * nbytes,))
            return dequantize(raw, info.ggml_type, count).reshape(info.shape)
        if info.ggml_type not in _TENSOR_DTYPES:
            raise ValueError(
                f"tensor {name!r} has unsupported ggml type {info.type_name}; F32/F16/BF16 "
                "and Q4_0/Q4_1/Q5_0/Q5_1/Q8_0/Q4_K/Q5_K/Q6_K load as arrays")
        dtype_name, _ = _TENSOR_DTYPES[info.ggml_type]
        if dtype_name == "bfloat16":  # numpy has no bf16: the upper half of f32's bits
            u16 = np.memmap(self.path, "<u2", "c", start, (count,))
            return (u16.astype(np.uint32) << 16).view(np.float32).reshape(info.shape)
        dtype = np.dtype(dtype_name).newbyteorder("<")
        return np.memmap(self.path, dtype, "c", start, (count,)).reshape(info.shape)

    # -- tokenizer ----------------------------------------------------------------

    def tokenizer_vocab(self) -> Optional[dict]:
        """The embedded vocabulary: model kind, token strings, scores, merge
        rules, special ids (the tokenizer.ggml.* keys)."""
        tokens = self.metadata.get("tokenizer.ggml.tokens")
        if tokens is None:
            return None
        return {
            "model": self.metadata.get("tokenizer.ggml.model", "llama"),
            "tokens": tokens,
            "scores": self.metadata.get("tokenizer.ggml.scores"),
            "token_types": self.metadata.get("tokenizer.ggml.token_type"),
            "merges": self.metadata.get("tokenizer.ggml.merges"),
            "bos_token_id": self.metadata.get("tokenizer.ggml.bos_token_id"),
            "eos_token_id": self.metadata.get("tokenizer.ggml.eos_token_id"),
            "chat_template": self.metadata.get("tokenizer.chat_template"),
        }

    # -- model config ---------------------------------------------------------------

    def architecture(self) -> str:
        return self.metadata.get("general.architecture", "llama")

    def to_llama_config(self):
        """The `{arch}.*` metadata as the port's LlamaConfig, field for field
        as the reference maps it. gemma2 and gemma3 (sliding windows,
        softcaps, post-block norms) and a linear or yarn rope scaling are
        refused by name: the port has no forward for them yet."""
        from dynamo_tpu_torch.models.llama import LlamaConfig

        arch = self.architecture()
        md = self.metadata

        def key(suffix, default=None):
            return md.get(f"{arch}.{suffix}", default)

        if arch in _WINDOWED_ARCHITECTURES:
            raise ValueError(
                f"GGUF architecture {arch!r} needs sliding windows, logit softcaps and "
                "post-block norms, which dynamo_tpu_torch does not serve yet")
        if arch not in _SERVED_ARCHITECTURES:
            raise ValueError(f"unsupported GGUF architecture {arch!r}")
        rope_type = key("rope.scaling.type")
        if rope_type not in (None, "none", "llama3"):
            raise ValueError(f"GGUF rope scaling type {rope_type!r} is not served by "
                             "dynamo_tpu_torch (llama3 NTK only)")
        n_heads = int(key("attention.head_count", 32))
        embed = int(key("embedding_length", 4096))
        head_dim = int(key("attention.key_length", embed // n_heads))
        vocab = md.get("tokenizer.ggml.tokens")
        vocab_size = int(key("vocab_size", len(vocab) if vocab else 32000))
        rope_scale = key("rope.scaling.factor")
        gemma_kw = {}
        if arch == "gemma":
            # llama.cpp's converter folds Gemma's (1 + w) norm offset into
            # the stored norms, so the config adds no offset; embeddings
            # scale at run time as usual
            gemma_kw = dict(hidden_act="gelu_tanh", rms_norm_unit_offset=False,
                            scale_embeddings=True, tie_word_embeddings=True)
        return LlamaConfig(
            attention_bias=(arch == "qwen2"),
            qk_norm=(arch == "qwen3"),
            vocab_size=vocab_size,
            hidden_size=embed,
            intermediate_size=int(key("feed_forward_length", 4 * embed)),
            num_layers=int(key("block_count", 32)),
            num_heads=n_heads,
            num_kv_heads=int(key("attention.head_count_kv", n_heads)),
            head_dim=head_dim,
            rope_theta=float(key("rope.freq_base", 10000.0)),
            rms_norm_eps=float(key("attention.layer_norm_rms_epsilon", 1e-5)),
            rope_scaling_factor=float(rope_scale) if rope_scale is not None else None,
            **gemma_kw,
        )

    def context_length(self) -> int:
        return int(self.metadata.get(f"{self.architecture()}.context_length", 4096))


# -- parsing ------------------------------------------------------------------------


class _Cursor:
    """A read position in the file's memory map."""

    def __init__(self, buf, path: str):
        self.buf, self.pos, self.path = buf, 0, path

    def scalar(self, fmt: str):
        try:
            (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        except struct.error:
            raise ValueError(f"{self.path}: unexpected end of GGUF file") from None
        self.pos += struct.calcsize(fmt)
        return v

    def string(self) -> str:
        n = self.scalar("<Q")
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.path}: unexpected end of GGUF file")
        s = bytes(self.buf[self.pos:self.pos + n]).decode("utf-8", errors="replace")
        self.pos += n
        return s

    def value(self, vtype: int):
        if vtype in _SCALAR_FMT:
            return self.scalar(_SCALAR_FMT[vtype])
        if vtype == _BOOL:
            return bool(self.scalar("<B"))
        if vtype == _STR:
            return self.string()
        if vtype == _ARR:
            elem_type = self.scalar("<I")
            count = self.scalar("<Q")
            if elem_type in _SCALAR_NP:  # fixed width: one read
                dt = np.dtype(_SCALAR_NP[elem_type])
                end = self.pos + count * dt.itemsize
                if end > len(self.buf):
                    raise ValueError(f"{self.path}: unexpected end of GGUF file")
                arr = np.frombuffer(self.buf, dt, count, self.pos)
                self.pos = end
                return arr.tolist()
            return [self.value(elem_type) for _ in range(count)]
        raise ValueError(f"{self.path}: unknown GGUF metadata value type {vtype}")


#: (absolute path, mtime_ns, size) -> the parse of that file; one entry
_PARSE_CACHE: dict[tuple, GgufFile] = {}


def read_gguf(path: str) -> GgufFile:
    """Parse the header, the metadata and the tensor index (no tensor
    data); the last file parsed is returned again while it is unchanged."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    hit = _PARSE_CACHE.get(key)
    if hit is None:
        hit = _parse(path)
        _PARSE_CACHE.clear()  # hold at most one file: a vocabulary can be large
        _PARSE_CACHE[key] = hit
    return hit


def _parse(path: str) -> GgufFile:
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
        cur = _Cursor(memoryview(buf), path)
        try:
            magic = cur.scalar("<I")
            if magic != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
            version = cur.scalar("<I")
            if version not in (2, 3):
                raise ValueError(f"{path}: unsupported GGUF version {version}")
            n_tensors = cur.scalar("<Q")
            n_kv = cur.scalar("<Q")
            metadata: dict[str, Any] = {}
            for _ in range(n_kv):
                key = cur.string()
                metadata[key] = cur.value(cur.scalar("<I"))
            tensors: dict[str, GgufTensorInfo] = {}
            for _ in range(n_tensors):
                name = cur.string()
                n_dims = cur.scalar("<I")
                # GGUF stores dims innermost first: reversed for numpy order
                dims = tuple(cur.scalar("<Q") for _ in range(n_dims))[::-1]
                ggml_type = cur.scalar("<I")
                offset = cur.scalar("<Q")
                tensors[name] = GgufTensorInfo(name, dims, ggml_type, offset)
            pos = cur.pos
        finally:
            cur.buf.release()
    alignment = int(metadata.get("general.alignment", 32))
    data_start = (pos + alignment - 1) // alignment * alignment
    return GgufFile(path=path, version=version, metadata=metadata, tensors=tensors,
                    data_start=data_start, alignment=alignment)


# -- writing (fixtures and tooling) ---------------------------------------------------


def write_gguf(path: str, metadata: dict[str, Any], tensors: dict[str, Any],
               alignment: int = 32) -> None:
    """A minimal GGUF v3 writer. Tensor values are F32/F16 numpy arrays, or
    `(ggml_type, shape, raw_bytes)` tuples carrying a payload packed
    already (quantize_q8_0's, say)."""

    def w_string(f, s: str):
        b = s.encode()
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def value_type(v) -> int:
        if isinstance(v, bool):
            return _BOOL
        if isinstance(v, int):
            return _I64 if v < 0 else _U64
        if isinstance(v, float):
            return _F64
        if isinstance(v, str):
            return _STR
        if isinstance(v, (list, tuple)):
            return _ARR
        raise TypeError(f"unsupported metadata value {type(v)}")

    def w_value(f, v, vtype: int):
        if vtype == _BOOL:
            f.write(struct.pack("<B", int(v)))
        elif vtype in _SCALAR_FMT:
            f.write(struct.pack(_SCALAR_FMT[vtype], v))
        elif vtype == _STR:
            w_string(f, v)
        elif vtype == _ARR:
            et = value_type(v[0]) if v else _U64
            f.write(struct.pack("<IQ", et, len(v)))
            if et in _SCALAR_NP:  # fixed width: one write
                f.write(np.asarray(v, _SCALAR_NP[et]).tobytes())
            else:
                for item in v:
                    w_value(f, item, et)

    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(tensors), len(metadata)))
        for k, v in metadata.items():
            w_string(f, k)
            vt = value_type(v)
            f.write(struct.pack("<I", vt))
            w_value(f, v, vt)
        offset = 0
        blobs = []
        for name, arr in tensors.items():
            if isinstance(arr, tuple):  # (ggml_type, shape, raw_bytes)
                gt, shape, blob = arr
            elif arr.dtype in (np.float32, np.float16):
                gt, shape = (0 if arr.dtype == np.float32 else 1), arr.shape
                blob = np.ascontiguousarray(arr)
            else:
                raise TypeError("write_gguf takes f32/f16 arrays or (ggml_type, shape, "
                                f"raw_bytes) tuples, not {arr.dtype}")
            w_string(f, name)
            dims = tuple(shape)[::-1]  # innermost first on disk
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<IQ", gt, offset))
            blobs.append((offset, blob))
            offset += (memoryview(blob).nbytes + alignment - 1) // alignment * alignment
        pos = f.tell()
        f.write(b"\x00" * ((pos + alignment - 1) // alignment * alignment - pos))
        data_start = f.tell()
        for off, blob in blobs:
            f.seek(data_start + off)
            f.write(memoryview(blob).cast("B") if isinstance(blob, np.ndarray) else blob)
