"""The page write's cases for the tests that hold the port's plain write
against the JAX paged_write (tests/test_torch_ops.py,
tests/test_torch_kv_quant.py)."""

import pytest

#: (B, T, S, valid rows) of the write's cases
WRITE_CASES = [
    (3, 1, 4, (1, 0, 1)),      # decode: T=1, a padding lane in the middle
    (2, 8, 4, (8, 5)),         # page-aligned prefill runs, ragged tail
    (2, 4, 4, (4, 0)),         # T == S, a whole padding sequence
    (2, 2, 4, (2, 1)),         # T < S: one run shorter than a page
    (2, 32, 4, (32, 13)),      # eight runs a sequence
]


def write_params():
    """Each write case at Hkv 2, 1 and 8, as (b, t, s, valid_rows, hkv); at
    Hkv 2 a case keeps the test id it had before Hkv varied."""
    return [
        pytest.param(b, t, s, rows, hkv,
                     id=f"{b}-{t}-{s}-valid_rows{i}" + ("" if hkv == 2 else f"-hkv{hkv}"))
        for i, (b, t, s, rows) in enumerate(WRITE_CASES)
        for hkv in (2, 1, 8)
    ]
