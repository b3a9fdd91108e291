"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled at first use, by hand, into one shared
library with a plain C interface, which is then loaded with ``ctypes``.
The sources compile in parallel, one ``nvcc`` each, then link::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <tmp>/<name>.o csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/kernels/libransac_tpu_torch_<hash>.so <tmp>/*.o

The library's name carries a hash of the sources (``*.cu`` and the
``*.cuh`` headers) and flags, so an edited kernel is rebuilt and an
unchanged one is reused.  ``ptxas``'s report (registers, spills, shared
memory per kernel) is kept beside the library as ``<library>.ptxas.txt``.
A missing ``nvcc`` or a failed compile raises ``RuntimeError`` (with
nvcc's stderr); nothing falls back.  ``torch.utils.cpp_extension.load`` is
not used: its PyTorch headers take minutes to compile where this takes
seconds.

``load`` sets the ``ctypes`` signature of every entry point from
``SIGNATURES``; each returns ``cudaGetLastError()`` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CUDA_HOME_DEFAULT = "/usr/local/cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_L = ctypes.c_longlong
_F = ctypes.c_float
#: argtypes of each C entry point, in order (the stream last).
SIGNATURES = {
    "sweep_multi_launch": [_P] * 5 + [_I] * 4 + [_P] * 4,
    "sweep_launch": [_P] * 3 + [_F] + [_U] * 4 + [_I] * 4 + [_P] * 4,
    "homography_scores_launch": [_P] * 4 + [_F, _P, _I, _I] + [_P] * 3,
    "pnp_scores_launch": [_P] * 4 + [_F, _P, _I, _I] + [_P] * 3,
    "sweep_pnp_launch": ([_P] * 5 + [_F, _F, _P, _P] + [_U] * 3 + [_I] * 5
                         + [_P] * 3),
    "sweep_large_launch": [_P] * 3 + [_F] + [_U] * 6 + [_I] * 3 + [_P] * 5,
    "sweep_pnp_large_launch": ([_P] * 3 + [_F, _F] + [_U] * 5 + [_I] * 4
                               + [_P] * 5),
    "sweep_essential_large_launch": ([_P] * 3 + [_F] + [_U] * 10 + [_I] * 4
                                     + [_P] * 5),
    "sweep_essential_launch": [_P] * 3 + [_F] + [_U] * 8 + [_I] * 5 + [_P] * 4,
    "roofline_chain_launch": [_F, _I, _I, _I, _P, _P],
    "roofline_mxu_launch": [_F, _I, _I, _P, _P],
    "lm_pose_launch": [_P, _L] * 6 + [_I] * 3 + [_P] * 5,
    "refit_homography_launch": [_P, _L] * 4 + [_I] * 3 + [_P] * 2,
    "refit_pose_launch": [_P] * 7 + [_F, _P, _F, _P] + [_I] * 2 + [_P] * 2,
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc from PATH, else $CUDA_HOME/bin, else /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_HOME_DEFAULT):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in "
        f"{CUDA_HOME_DEFAULT}/bin: the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libransac_tpu_torch_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels/`` unless a library for
    the same sources and flags is already there; return its path."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        jobs = [(src, Path(obj_dir) / f"{src.stem}.o")
                for src in sorted(CSRC_DIR.glob("*.cu"))]
        procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for src, obj in jobs]
        outputs = [proc.communicate() for proc in procs]
        for (src, _), proc, (_, err) in zip(jobs, procs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} (exit code "
                                   f"{proc.returncode}):\n{err}")
        tmp = Path(obj_dir) / out.name
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *(str(obj) for _, obj in jobs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to link (exit code "
                               f"{proc.returncode}):\n{proc.stderr}")
        report_path(out).write_text("".join(
            f"== {src.name}\n{o}{e}" for (src, _), (o, e) in zip(jobs, outputs)))
        os.replace(tmp, out)
    return out


def report_path(library: Path) -> Path:
    """Where ``ptxas -v``'s report of ``library`` is kept."""
    return library.with_name(library.name + ".ptxas.txt")


def ptxas_report() -> str:
    """``ptxas -v`` output of the built library's kernels ('' if none)."""
    path = report_path(library_path())
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once, with the
    argtypes of every entry point set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
