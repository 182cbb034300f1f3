"""Packaging of the port: a wheel carries every kernel source (and the
native hash's ``csrc/kfs_hash.cpp``), and an installed copy builds its
kernels and the hash library in a writable directory.

``csrc/sep_stencil.cu`` includes ``csrc/sep_stencil.cuh``, so a wheel that
lists only ``*.cu`` in its package data ships a kernel without its body,
and ``build()`` fails in nvcc.  A checkout builds into its own
``build/krylovfspssa_tpu_torch/`` (ignored by git); an installed copy has
no checkout around it and builds into a user cache directory instead of
``site-packages``."""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from krylovfspssa_tpu_torch import native
from krylovfspssa_tpu_torch.ops import stencil_cuda

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "krylovfspssa_tpu_torch"


def _package_data_globs():
    with open(ROOT / "pyproject.toml", "rb") as fh:
        conf = tomllib.load(fh)
    return conf["tool"]["setuptools"]["package-data"][
        "krylovfspssa_tpu_torch"]


@pytest.mark.parametrize(
    "source", sorted(p.relative_to(PACKAGE).as_posix()
                     for p in (PACKAGE / "csrc").iterdir() if p.is_file()))
def test_every_kernel_source_is_package_data(source):
    assert any(fnmatch.fnmatch(source, g) for g in _package_data_globs()), (
        f"{source} is not in [tool.setuptools.package-data]")


def test_kernel_sources_include_the_body():
    names = {p.name for p in (PACKAGE / "csrc").iterdir()}
    assert {"sep_stencil.cu", "sep_stencil.cuh", "kfs_hash.cpp"} <= names


def test_checkout_builds_into_its_build_directory():
    assert stencil_cuda._BUILD == ROOT / "build" / "krylovfspssa_tpu_torch"
    assert stencil_cuda._CSRC == PACKAGE / "csrc"


def test_installed_copy_builds_into_a_user_cache(tmp_path, monkeypatch):
    site = tmp_path / "site-packages"
    (site / "krylovfspssa_tpu_torch").mkdir(parents=True)
    package = site / "krylovfspssa_tpu_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert stencil_cuda._build_dir(package) == (
        tmp_path / "cache" / "krylovfspssa_tpu_torch")
    # a checkout keeps its own directory whatever the environment says
    (tmp_path / "pyproject.toml").write_text("")
    checkout = tmp_path / "krylovfspssa_tpu_torch"
    assert stencil_cuda._build_dir(checkout) == (
        tmp_path / "build" / "krylovfspssa_tpu_torch")


def test_hash_library_builds_beside_the_kernels():
    """The native hash compiles from the port's own copy of the source into
    the kernels' build directory (no file of the JAX package is read)."""
    assert native._SRC == PACKAGE / "csrc" / "kfs_hash.cpp"
    assert native._BUILD == stencil_cuda._BUILD
    assert native.build().path == native._BUILD / "libkfs_hash.so"
