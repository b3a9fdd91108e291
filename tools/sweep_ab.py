"""Time the <= 16-point sweep kernels of the PyTorch/CUDA port (kernel rows 2
and 7, ``sweep.cu`` and ``sweep_essential.cu``) from several source trees
in turns on one card, and count their SASS instructions by class.

    python tools/sweep_ab.py DIR [DIR ...]     # from the repository root

Each DIR holds ``sweep.cu``, ``sweep_essential.cu`` and their headers: a
copy of ``ransac_tpu_torch/csrc/`` as some commit has it, or the checkout's
own.  Each tree is built with the port's nvcc flags (``ops/_build.py``)
into ``build/sweep_ab/<k>/``, ptxas's registers and spills are read, and
``cuobjdump -sass`` gives the static instructions of ``sweep_kernel`` and
``sweep_essential_kernel`` by class.  The kernel bodies have no loops (16
points unrolled), so at 16 scored points a hypothesis issues about the
count over the hypotheses a thread carries.

Row 2 runs on the bench problem (``bench.problem``, 13 points) at 2^22
hypotheses, row 7 on 16 uniform random correspondences (``cli profile``'s
kind of row) at 2^20, reduced records; each tree's records there are
compared with the plain versions (bit for bit, and the fraction of equal
counts).  Timing: CUDA events around 50 calls (prep + sweep) of each tree,
the trees in turns (A B C, then C B A, ...), the median of 6 rounds; each
kernel's device time from torch.profiler.  Prints one JSON line per tree
with the card's name and power limit.  Needs a card, nvcc and cuobjdump.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ransac_tpu_torch import bench  # noqa: E402
from ransac_tpu_torch.ops import _build  # noqa: E402
from ransac_tpu_torch.ops import sweep as sw  # noqa: E402
from ransac_tpu_torch.ops import sweep_essential as se  # noqa: E402
from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD  # noqa: E402

KERNELS = {"sweep.cu": "sweep_kernel", "sweep_essential.cu": "sweep_essential_kernel"}
CLASSES = ("FFMA", "FMUL", "FADD", "IMAD", "LDS", "SHFL", "MUFU")
ROUNDS, CALLS = 6, 50


def build(tree: Path, work: Path) -> tuple[ctypes.CDLL, dict]:
    """Compile and link the two kernels of ``tree``: the bound library and
    {kernel: ptxas registers, spills, SASS classes}."""
    nvcc = _build.find_nvcc()
    work.mkdir(parents=True, exist_ok=True)
    objs = {src: work / f"{Path(src).stem}.o" for src in KERNELS}
    procs = {src: subprocess.Popen([nvcc, *_build.COMPILE_FLAGS, "-o", str(obj),
                                    str(tree / src)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for src, obj in objs.items()}
    reports = {src: p.communicate()[0] for src, p in procs.items()}
    for src, p in procs.items():
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tree / src}:\n{reports[src]}")
    lib_path = work / "libsweep_ab.so"
    subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(lib_path),
                    *(str(o) for o in objs.values())], check=True, capture_output=True)
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    info = {}
    for src, kernel in KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(objs[src])], check=True,
                              capture_output=True, text=True).stdout
        info[kernel] = {**ptxas_of(reports[src], kernel), "sass": sass_classes(sass, kernel)}
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("sweep_launch", "sweep_essential_launch"):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib, info


def ptxas_of(report: str, kernel: str) -> dict:
    """Registers and spill bytes of ``kernel`` in ``nvcc -Xptxas -v`` output."""
    out, inside = {}, False
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            inside = re.search(rf"\d{kernel}E", m[1]) is not None
        elif inside:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out["spill_bytes"] = int(m[1]) + int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["registers"] = int(m[1])
    return out


def sass_classes(sass: str, kernel: str) -> dict:
    """Static instructions of ``kernel`` in ``cuobjdump -sass`` output by
    class, and the ten commonest opcodes of the rest."""
    counts = dict.fromkeys((*CLASSES, "other", "total"), 0)
    other: dict = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = re.search(rf"\d{kernel}E", line) is not None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and m:
            cls = next((c for c in CLASSES if m[1].startswith(c)), "other")
            counts[cls] += 1
            counts["total"] += 1
            if cls == "other":
                other[m[1]] = other.get(m[1], 0) + 1
    counts["other_opcodes"] = dict(sorted(other.items(), key=lambda kv: -kv[1])[:10])
    return counts


def cases():
    """{row: (entry, plain function, arguments of the wrappers' cores)}."""
    src, dst, mask = bench.problem("cuda")
    rng = np.random.default_rng(0)
    x1, x2 = (torch.as_tensor(rng.uniform(-0.5, 0.5, (16, 2)), dtype=torch.float32,
                              device="cuda") for _ in range(2))
    return {2: ("sweep_launch", sw._sweep_plain,
                (src, dst, mask, 75.0, sw.draw_seeds(5, 4), 13, 1 << 22)),
            7: ("sweep_essential_launch", se._sweep_plain,
                (x1, x2, torch.ones(16, device="cuda"), ESSENTIAL_THRESHOLD,
                 sw.draw_seeds(0, 8), 16, 1 << 20, se.BLOCK_H))}


def caller(lib, entry, args):
    """One call of ``lib``'s entry on ``args`` -> (f [4, B], i [2, B])."""
    a, b, mask, thr, seeds, n_points, n_hyp, *block = args
    B = n_hyp // 8
    prep = torch.empty((se.PREP_FLOATS,), dtype=torch.float32, device="cuda")
    f = torch.empty((4, B), dtype=torch.float32, device="cuda")
    i = torch.empty((2, B), dtype=torch.int32, device="cuda")

    def call():
        err = getattr(lib, entry)(a.data_ptr(), b.data_ptr(), mask.data_ptr(), float(thr),
                                  *seeds, n_points, a.shape[0], n_hyp, *block, 0,
                                  prep.data_ptr(), f.data_ptr(), i.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{entry} failed: CUDA error {err}")
        return f, i
    return call


def plain_records(row, plain, args):
    out = plain(*args, False)
    if row == 2:  # (msac [2, B], counts [2, B], packed) -> the kernel's (f, i)
        msac, counts, i = out
        return torch.stack([msac[0], counts[0], msac[1], counts[1]]), i
    return out


def events_ms(call) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(CALLS):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def device_us(call, symbols, reps=10) -> dict:
    """{symbol: mean device microseconds} over ``reps`` calls (torch.profiler;
    None where it records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for symbol in symbols:
        evs = [ev for ev in prof.key_averages() if re.search(rf"(::|\d){symbol}(\(|E)", ev.key)]
        total = sum(getattr(ev, "device_time_total", 0.0) for ev in evs)
        count = sum(ev.count for ev in evs)
        out[symbol] = total / count if count and total > 0 else None
    return out


def main(trees: list[str]) -> int:
    if not trees or not torch.cuda.is_available():
        print("usage: python tools/sweep_ab.py DIR [DIR ...] (needs a CUDA device)",
              file=sys.stderr)
        return 1
    results, libs = [], []
    for k, tree in enumerate(trees):
        lib, info = build(Path(tree), _build.BUILD_DIR.parent / "sweep_ab" / str(k))
        libs.append(lib)
        results.append({"tree": tree, **info})
    for row, (entry, plain, args) in cases().items():
        f_p, i_p = plain_records(row, plain, args)
        calls = [caller(lib, entry, args) for lib in libs]
        for res, call in zip(results, calls):
            f_k, i_k = call()
            res[f"row{row}"] = {
                "equal": bool(torch.equal(f_k, f_p) and torch.equal(i_k, i_p)),
                "counts_equal_fraction": float((f_k[1::2] == f_p[1::2]).double().mean())}
        torch.cuda.synchronize()
        times = [[] for _ in calls]
        for r in range(ROUNDS):
            order = range(len(calls)) if r % 2 == 0 else reversed(range(len(calls)))
            for k in order:
                times[k].append(events_ms(calls[k]))
        symbol = entry.removesuffix("_launch")
        for res, call, ms in zip(results, calls, times):
            dev = device_us(call, [f"{symbol}_kernel", f"{symbol}_prep_kernel"])
            res[f"row{row}"].update(ms_median=statistics.median(ms), ms_all=ms,
                                    kernel_device_us=dev[f"{symbol}_kernel"],
                                    prep_device_us=dev[f"{symbol}_prep_kernel"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    for res in results:
        print(json.dumps({**res, "gpu": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
