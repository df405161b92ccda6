"""The kernel build's reuse of a library built from the same source.

``kernels/_build.py`` keys each library by a hash of its source and of
``NVCC_FLAGS``.  Here a stand-in for ``nvcc`` (a script that records its
calls and links an empty shared library with the host's C compiler) shows
that a second build of the same sources runs no compiler, that a changed
source, included header or flag rebuilds, and that a failed build still
raises.
"""

import shutil
import sys

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a C compiler to stand in for nvcc")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import subprocess, sys\n"
        "args = sys.argv[1:]\n"
        f"open({str(calls)!r}, 'a').write(args[-1] + '\\n')\n"
        "if 'FAIL' in open(args[-1]).read():\n"
        "    sys.exit('nvcc: error')\n"
        "out = args[args.index('-o') + 1]\n"
        f"sys.exit(subprocess.call([{cc!r}, '-shared', '-fPIC', '-x', 'c',"
        " '/dev/null', '-o', out]))\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))

    def build() -> int:
        """Build as a new process would; the number of nvcc calls."""
        monkeypatch.setattr(_build, "_libs", {})
        before = len(calls.read_text().split()) if calls.exists() else 0
        libs = _build.build_all()
        assert sorted(libs) == ["alpha", "beta"]
        return len(calls.read_text().split()) - before

    return csrc, build


def test_a_second_build_runs_no_compiler(fake_build):
    _, build = fake_build
    assert build() == 2
    assert build() == 0
    keys = sorted(p.name for p in _build.BUILD_DIR.glob("*.key"))
    assert keys == ["libalpha.so.key", "libbeta.so.key"]


def test_a_changed_source_or_flag_rebuilds(fake_build, monkeypatch):
    csrc, build = fake_build
    assert build() == 2
    (csrc / "alpha.cu").write_text("// alpha, changed\n")
    assert build() == 1
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert build() == 2
    assert build() == 0


def test_a_failed_build_raises_and_keeps_no_key(fake_build):
    csrc, build = fake_build
    (csrc / "beta.cu").write_text("// FAIL\n")
    with pytest.raises(RuntimeError, match="beta.cu"):
        build()
    assert not (_build.BUILD_DIR / "libbeta.so.key").exists()
    (csrc / "beta.cu").write_text("// beta\n")
    assert build() == 1          # alpha was kept


def test_a_changed_header_rebuilds_the_sources_that_include_it(fake_build):
    """``alpha.cu`` includes ``common.cuh``, which includes ``inner.cuh``;
    ``beta.cu`` includes neither: a changed header rebuilds alpha alone, an
    unchanged one nothing."""
    csrc, build = fake_build
    (csrc / "alpha.cu").write_text('// alpha\n#include "common.cuh"\n')
    (csrc / "common.cuh").write_text('// common\n#include "inner.cuh"\n')
    (csrc / "inner.cuh").write_text("// inner\n")
    assert build() == 2
    assert build() == 0
    (csrc / "common.cuh").write_text('// common, changed\n'
                                     '#include "inner.cuh"\n')
    assert build() == 1
    (csrc / "inner.cuh").write_text("// inner, changed\n")
    assert build() == 1
    assert build() == 0
    assert sorted(p.name for p in _build.BUILD_DIR.glob("lib*.so")) == [
        "libalpha.so", "libbeta.so"]
