"""The port's kernel build (``ops/cuda_build.py``) with a stand-in compiler.

A shell script takes nvcc's place, so the build's bookkeeping (parallel
start, hash-named outputs, reuse, error reports) runs without the CUDA
toolkit; the real compile is exercised on the card by ``chip_smoke.py``.
"""

import stat

import pytest

from autorag_research_tpu_torch.ops import cuda_build


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "_build"
    monkeypatch.setattr(cuda_build, "BUILD_DIR", out)
    return out


def test_build_all_compiles_each_source_once(tmp_path, monkeypatch, build_dir):
    log = tmp_path / "calls"
    # writes the file named after -o, and logs the source it was given
    nvcc = _fake_nvcc(
        tmp_path,
        f'while [ "$1" != "-o" ]; do shift; done; touch "$2"; echo "$3" >> {log}\n',
    )
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    first = cuda_build.build_all()
    assert set(first) == set(cuda_build.KERNEL_SOURCES)
    built = sorted(p.name for p in build_dir.iterdir())
    assert len(built) == len(cuda_build.KERNEL_SOURCES)
    assert all(name.endswith(".so") for name in built)
    again = cuda_build.build_all()  # unchanged sources: reused, not rebuilt
    assert again == {n: 0.0 for n in cuda_build.KERNEL_SOURCES}
    assert len(log.read_text().splitlines()) == len(cuda_build.KERNEL_SOURCES)


def test_build_failure_reports_every_source(tmp_path, monkeypatch, build_dir):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: stand-in failure"; exit 3\n')
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError) as info:
        cuda_build.build_all()
    for name in cuda_build.KERNEL_SOURCES:
        assert f"{name}.cu (exit 3)" in str(info.value)
    assert not any(build_dir.iterdir())  # no partial outputs left behind
    with pytest.raises(RuntimeError):
        cuda_build.check_launch(9, "dense_topk_stream")
    cuda_build.check_launch(0, "dense_topk_stream")
