"""The measuring tools' shared helpers (``gr_dtl_tpu_torch/tools/_timing.py``)
that need no card: a variant's source written from the kernel's source, and
a wrapper module launching another build for the length of a block."""

import types

import pytest

from gr_dtl_tpu_torch.ops import _cuda_build, equalizer_cuda, ldpc_cuda, llr_cuda
from gr_dtl_tpu_torch.tools import _timing


def test_written_replaces_in_order_and_refuses_missing_text(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("constexpr int kA = 1;\nconstexpr int kB = 2;\n")
    subs = (("kA = 1", "kA = 3"), ("kA = 3;\nconstexpr int kB = 2", "kA = 4;\nconstexpr int kB = 5"))
    assert _timing.written(src, subs, "t") == "constexpr int kA = 4;\nconstexpr int kB = 5;\n"
    with pytest.raises(ValueError, match="no longer holds 'kC'"):
        _timing.written(src, (("kC", "kD"),), "t")


@pytest.mark.parametrize("module", [llr_cuda, equalizer_cuda, ldpc_cuda], ids=lambda m: m.__name__.split(".")[-1])
def test_variant_source_is_named_by_its_text(module, monkeypatch, tmp_path):
    """A variant's source lands in the build directory under its stem and
    the hash of its text: the same edit gives the same file, another edit
    another file, and the kernel's own source is left as it was."""
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    text = module.SOURCE.read_text()
    old = text.splitlines()[0]
    one = _timing.variant_source(module.SOURCE, ((old, old + " // one"),), "v")
    again = _timing.variant_source(module.SOURCE, ((old, old + " // one"),), "v")
    two = _timing.variant_source(module.SOURCE, ((old, old + " // two"),), "v")
    assert one == again != two and one.parent == tmp_path / "_build" and one.name.startswith("v_")
    assert one.read_text() == text.replace(old, old + " // one", 1) and module.SOURCE.read_text() == text


def test_launching_swaps_the_build_for_the_block_only():
    wrapper = types.SimpleNamespace(build=lambda: "own")
    with _timing.launching(wrapper, "other"):
        assert wrapper.build() == "other"
    assert wrapper.build() == "own"
    with pytest.raises(RuntimeError):
        with _timing.launching(wrapper, "other"):
            raise RuntimeError("a failed call")
    assert wrapper.build() == "own"
