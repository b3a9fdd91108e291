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

``KERNELS`` is the one table of the port's kernels: each name maps to its
C entry point and that entry's ``ctypes`` argtypes, which ``load`` sets.
Every entry returns ``cudaGetLastError()`` of its launch.  ``launch`` is
the one way a wrapper calls a kernel, and ``LAUNCHES`` counts the calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

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
_CHAIN = [_F, _I, _I, _I, _P, _P]
#: Every kernel, by the name its launches are counted under: (its C entry
#: point, that entry's argtypes in order, the stream last).  The FMA and
#: mixed roofline chains are two kinds of one entry.
KERNELS = {
    "sweep_multi": ("sweep_multi_launch", [_P] * 5 + [_I] * 4 + [_P] * 4),
    "homography_ransac_sweep": (
        "sweep_launch", [_P] * 3 + [_F] + [_U] * 4 + [_I] * 4 + [_P] * 4),
    "pnp_ransac_sweep": (
        "sweep_pnp_launch", [_P] * 5 + [_F, _F, _P, _P] + [_U] * 3 + [_I] * 5 + [_P] * 3),
    "homography_ransac_sweep_large": (
        "sweep_large_launch", [_P] * 3 + [_F] + [_U] * 6 + [_I] * 3 + [_P] * 5),
    "essential_ransac_sweep": (
        "sweep_essential_launch", [_P] * 3 + [_F] + [_U] * 8 + [_I] * 5 + [_P] * 4),
    "essential_ransac_sweep_large": (
        "sweep_essential_large_launch", [_P] * 3 + [_F] + [_U] * 10 + [_I] * 4 + [_P] * 5),
    "pnp_ransac_sweep_large": (
        "sweep_pnp_large_launch", [_P] * 3 + [_F, _F] + [_U] * 5 + [_I] * 4 + [_P] * 5),
    "homography_scores": ("homography_scores_launch", [_P] * 4 + [_F, _P, _I, _I] + [_P] * 3),
    "pnp_scores": ("pnp_scores_launch", [_P] * 4 + [_F, _P, _I, _I] + [_P] * 3),
    "roofline_fma": ("roofline_chain_launch", _CHAIN),
    "roofline_mixed": ("roofline_chain_launch", _CHAIN),
    "roofline_mxu": ("roofline_mxu_launch", [_F, _I, _I, _P, _P]),
    "lm_pose": ("lm_pose_launch", [_P, _L] * 6 + [_I] * 3 + [_P] * 5),
    "refit_homography": ("refit_homography_launch", [_P, _L] * 4 + [_I] * 3 + [_P] * 2),
    "refit_pose": ("refit_pose_launch", [_P] * 7 + [_F, _P, _F, _P] + [_I] * 2 + [_P] * 2),
}

#: Launches of each kernel in this process (``utils.profiling.launch_counts``).
#: Only ``launch`` adds to them; the plain versions never do.
LAUNCHES = dict.fromkeys(KERNELS, 0)

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
        for entry, argtypes in KERNELS.values():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, device, *args) -> None:
    """Call ``kernel``'s entry point on ``device``'s current stream with
    ``args`` (a tensor by its ``data_ptr()``), raise on the CUDA error it
    returns, and count the launch in ``LAUNCHES``."""
    entry = KERNELS[kernel][0]
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(load(), entry)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    LAUNCHES[kernel] += 1


def check_inputs(kernel: str, device, **tensors):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype on
    ``device``; ``tensors`` maps name -> (tensor, dtype)."""
    if device.type != "cuda":
        raise ValueError(f"the {kernel} kernel needs CUDA tensors, got {device}")
    for name, (t, dtype) in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dtype} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")


def f32_of(value):
    """``value`` in float32 where it lies: a number as the float of its
    float32 rounding, a tensor as a 0-d float32 tensor (cast on its device,
    never read back)."""
    if isinstance(value, torch.Tensor):
        return value.to(torch.float32).reshape(())
    return float(np.float32(value))


def f32_arg(value, device):
    """(float, tensor or None) for an entry point that takes a float32 by
    value and a pointer that, where not null, stands in for it on the card:
    a number goes by value and a null pointer; a tensor as a 0-d float32
    tensor on ``device``, which ``launch`` passes by its pointer.  Nothing is
    read back from the card."""
    if isinstance(value, torch.Tensor):
        return 0.0, f32_of(value.to(device))
    return f32_of(value), None
