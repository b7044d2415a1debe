"""The port's build helpers for timing kernel sources against each other
(scripts/torch_*_variants.py): which sources they take and what they read
back from nvcc's log. Neither needs nvcc or a card."""

import pytest

from dynamo_tpu_torch.ops import _build


def test_variant_sources_takes_the_committed_kernel_and_named_files(tmp_path):
    old = tmp_path / "csrc" / "paged_prefill.cu"
    old.parent.mkdir()
    old.write_text("// an earlier design\n")
    srcs = _build.variant_sources("paged_prefill", [f"parent={old}"])
    assert list(srcs) == ["committed", "parent"]
    assert srcs["committed"] == _build.CSRC / "paged_prefill.cu"
    assert srcs["committed"].is_file()
    # a file is built where it lies, so it keeps the headers beside it
    assert srcs["parent"] == old.resolve()


@pytest.mark.parametrize("entry", ["parent", "parent=", "committed={old}",
                                   "missing={missing}"])
def test_variant_sources_refuses_a_bad_entry(tmp_path, entry):
    old = tmp_path / "old.cu"
    old.write_text("// an earlier design\n")
    entry = entry.format(old=old, missing=tmp_path / "missing.cu")
    with pytest.raises(ValueError, match="NAME=PATH"):
        _build.variant_sources("paged_prefill", [entry])


def test_variant_sources_refuses_a_name_given_twice(tmp_path):
    old = tmp_path / "old.cu"
    old.write_text("// an earlier design\n")
    with pytest.raises(ValueError, match="NAME=PATH"):
        _build.variant_sources("paged_attention", [f"a={old}", f"a={old}"])


def test_ptxas_registers_reads_each_entry():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z3fooILi64EEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z3fooILi64EEvv",
        "ptxas info    : Used 122 registers, used 1 barriers, 50176 bytes smem",
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Used 99 registers",  # no entry open: not counted
    ])
    assert _build.ptxas_registers(log) == {"_Z3fooILi64EEvv": 122, "_Z3barv": 40}


def test_sources_name_every_kernel_file():
    """Every csrc/*.cu is built (the int8 weight product among them), and
    a library's build key covers its source and the shared headers."""
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    assert "int8_matmul" in _build.SOURCES
    path = _build.library_path("int8_matmul")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libint8_matmul-")
