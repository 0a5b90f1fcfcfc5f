"""The kernel build's cache key, on the CPU (no nvcc needed).

A built library is reused when its name matches, and the name is a digest of
what the build reads. Both flash-attention sources include ``hopper.cuh``,
so an edited header must give a new name, or a stale library would be
loaded.
"""

import re

import pytest

from repro_torch.kernels import _build


def _write(path, text):
    path.write_text(text)
    return path


def test_library_name_follows_the_source_the_headers_and_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    _write(tmp_path / "k.cu", '#include "h.cuh"\nint f() { return g(); }\n')
    header = _write(tmp_path / "h.cuh", "inline int g() { return 1; }\n")
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR
    assert re.fullmatch(r"libk-[0-9a-f]{16}\.so", first.name)
    assert _build.library_path("k") == first                # stable

    _write(tmp_path / "notes.txt", "not read by the build")
    assert _build.library_path("k") == first

    _write(header, "inline int g() { return 2; }\n")
    edited_header = _build.library_path("k")
    assert edited_header != first

    _write(tmp_path / "k.cu", '#include "h.cuh"\nint f() { return -g(); }\n')
    assert _build.library_path("k") != edited_header

    monkeypatch.setitem(_build.KERNEL_FLAGS, "k", ("-O0",))
    assert _build.library_path("k") != edited_header


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
def test_the_flash_source_includes_only_headers_the_digest_covers(source):
    src = (_build._CSRC / source).read_text()
    local = re.findall(r'^#include "([^"]+)"', src, re.M)
    assert local == ["hopper.cuh"]
    assert all((_build._CSRC / name).is_file() and name.endswith(".cuh")
               for name in local)
