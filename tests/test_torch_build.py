"""The port's kernel builder (``repro_torch.kernels._build``) on the CPU.

A stand-in for ``nvcc`` writes the library it is asked for, so the
builder's bookkeeping (one compile per source, all at once, each timed and
logged, nothing rebuilt while the sources are unchanged, a failed compile
raising with the source's name) is checked without a CUDA toolkit.
"""

import importlib.util
import shutil
import stat
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]

FAKE_NVCC = """\
import sys
args = sys.argv[1:]
if any("{fail}" in a for a in args):
    print("error: {fail}.cu refused")
    sys.exit(2)
print("ptxas info    : Used 40 registers")
open(args[args.index("-o") + 1], "wb").write(b"lib")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def install(fail="no-such-source"):
        script = tmp_path / "nvcc"
        script.write_text(f"#!{sys.executable}\n" + FAKE_NVCC.format(fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IXUSR)
        monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
        monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
        monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    return install


def test_build_compiles_each_source_once_and_times_it(fake_nvcc):
    fake_nvcc()
    names = ("bitplane", "flash_attention")
    libs = _build.build(names)
    assert sorted(libs) == sorted(names)
    for name, path in libs.items():
        assert path.read_bytes() == b"lib"
        assert "registers" in (path.parent / f"lib{name}.log").read_text()
        assert _build.BUILD_SECONDS[name] > 0
    _build.BUILD_SECONDS.clear()
    assert _build.build(names) == libs      # built already: nothing recompiles
    assert _build.BUILD_SECONDS == {}


def test_build_failure_names_the_source(fake_nvcc):
    fake_nvcc(fail="bitplane")
    with pytest.raises(RuntimeError, match=r"bitplane\.cu \(exit 2\)"):
        _build.build(("bitplane", "compaction"))
    assert _build.library_path("compaction").exists()
    assert not _build.library_path("bitplane").exists()


def test_kernel_comparison_script_needs_a_card(monkeypatch, capsys):
    """``scripts/compare_kernels.py`` builds and times kernels on a GPU only:
    without one it exits non-zero before building anything."""
    spec = importlib.util.spec_from_file_location("compare_kernels",
                                                  ROOT / "scripts" / "compare_kernels.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(module, "build", lambda *a: pytest.fail("built without a card"))
    assert module.main(["--baseline", str(ROOT)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_build_hash_covers_the_shared_verdict_header(tmp_path, monkeypatch):
    """Every file in ``csrc/`` feeds the build hash, the tensor-core verdict
    kernels' shared main loop ``planes_mma.cuh`` among them, so an edit to it
    rebuilds both sources that include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.build_dir()
    header = csrc / "planes_mma.cuh"
    header.write_text(header.read_text() + "\n")
    assert _build.build_dir() != before
    for name in ("bitmap_filter", "compaction"):
        assert name in _build.SOURCES
        assert '#include "planes_mma.cuh"' in (csrc / f"{name}.cu").read_text()


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_verdict_breakdown_needs_a_card_and_matches_the_header(monkeypatch, capsys):
    """``scripts/verdict_breakdown.py`` exits non-zero without a GPU before
    building anything, and every line its variants switch off is still in
    ``planes_mma.cuh`` (it refuses to run otherwise)."""
    module = _script("verdict_breakdown")
    header = (_build.CSRC / "planes_mma.cuh").read_text()
    for _, old, _ in module.SWITCHES:
        assert old in header
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(module, "build_variant", lambda *a: pytest.fail("built without a card"))
    assert module.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
