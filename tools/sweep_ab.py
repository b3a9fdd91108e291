"""Time the redesigned sweep kernels of the PyTorch/CUDA port (kernel rows 2,
5, 7 and 9: ``sweep.cu``, ``sweep_pnp.cu``, ``sweep_essential.cu`` and
``sweep_pnp_large.cu``) from several source trees in turns on one card,
and count their SASS instructions by class.

    python tools/sweep_ab.py DIR [DIR ...]     # from the repository root

Each DIR holds those four sources and their headers: a copy of
``ransac_tpu_torch/csrc/`` as some commit has it, or the checkout's own
(a tree whose ``sweep_pnp_large.cu`` has no ``full`` argument is an older
one, called without it).  The trees are built at once with the port's
nvcc flags (``ops/_build.py``) into ``build/sweep_ab/<k>/``, ptxas's registers and
spills are read, and ``cuobjdump -sass`` gives the static instructions of
each sweep kernel by class.

Row 2 runs on the bench problem (``bench.problem``, 13 points) at 2^22
hypotheses, row 7 on 16 uniform random correspondences at 2^20, row 5 on
13 uniform random 3D-2D correspondences at 2^20 and row 9 on 256 at 2^20
(``cli profile``'s kind of rows: ``numpy.random.default_rng(0)``, 30 px at
f = 900), reduced records; each tree's records there are compared with the
plain versions (bit for bit, and the fraction of equal counts), and rows 5
and 9 carry the share of valid (sample, root) pairs of their inputs.  Timing:
CUDA events around 50 calls (prep + sweep) of each tree, the trees in
turns (A B C, then C B A, ...), the median of 6 rounds; each kernel's
device time from torch.profiler.  Prints one JSON line per tree with the
card's name and power limit.  Needs a card, nvcc and cuobjdump.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ransac_tpu_torch import bench  # noqa: E402
from ransac_tpu_torch.ops import _build  # noqa: E402
from ransac_tpu_torch.ops import sweep as sw  # noqa: E402
from ransac_tpu_torch.ops import sweep_essential as se  # noqa: E402
from ransac_tpu_torch.ops import sweep_pnp as sp  # noqa: E402
from ransac_tpu_torch.ops import sweep_pnp_large as spl  # noqa: E402
from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD  # noqa: E402

KERNELS = {"sweep.cu": "sweep_kernel", "sweep_essential.cu": "sweep_essential_kernel",
           "sweep_pnp.cu": "sweep_pnp_kernel", "sweep_pnp_large.cu": "sweep_pnp_large_kernel"}
ENTRIES = {2: "sweep_launch", 7: "sweep_essential_launch", 5: "sweep_pnp_launch",
           9: "sweep_pnp_large_launch"}
CLASSES = ("FFMA", "FMUL", "FADD", "IMAD", "LDS", "SHFL", "MUFU")
ROUNDS, CALLS = 6, 50
P3P_THRESHOLD = 30.0 / 900.0


def build(tree: Path, work: Path) -> tuple[ctypes.CDLL, dict]:
    """Compile and link the four kernels of ``tree``: the bound library and
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
    lib.row9_full_arg = "int block_h, int full" in (tree / "sweep_pnp_large.cu").read_text()
    for fn in ENTRIES.values():
        argtypes = list(_build.SIGNATURES[fn])
        if fn == "sweep_pnp_large_launch" and not lib.row9_full_arg:
            argtypes.remove(ctypes.c_int)
        getattr(lib, fn).argtypes = argtypes
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
    """{row: (arguments, plain records (f [4, B], i [2, B]))}, and for rows 5
    and 9 {row: the share of valid (sample, root) pairs} (``valid_root_share``)."""
    src, dst, mask = bench.problem("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")
    x1, x2 = (t(rng.uniform(-0.5, 0.5, (16, 2))) for _ in range(2))
    row2 = (src, dst, mask, 75.0, sw.draw_seeds(5, 4), 13, 1 << 22)
    row7 = (x1, x2, torch.ones(16, device="cuda"), ESSENTIAL_THRESHOLD,
            sw.draw_seeds(0, 8), 16, 1 << 20, se.BLOCK_H)
    msac, counts, i = sw._sweep_plain(*row2, False)
    out = {2: (row2, (torch.stack([msac[0], counts[0], msac[1], counts[1]]), i)),
           7: (row7, se._sweep_plain(*row7, False))}
    X, pixn = t(rng.uniform(-2, 2, (13, 3))), t(rng.uniform(-0.5, 0.5, (13, 2)))
    row5 = (*sp.prepare(X, pixn, torch.ones(13, device="cuda"), P3P_THRESHOLD, 1.0),
            sw.draw_seeds(0, 3), 13, 13, 1 << 20, sp.BLOCK_H)
    out[5] = (row5, sp._sweep_plain(*row5, False))
    shares = {5: sp.valid_root_share(0, X, pixn, torch.ones(13, device="cuda"),
                                     P3P_THRESHOLD, 1 << 20, block_h=sp.BLOCK_H)}
    XL, pixL = t(rng.uniform(-2, 2, (256, 3))), t(rng.uniform(-0.5, 0.5, (256, 2)))
    row9 = (XL, pixL, torch.ones(256, device="cuda"), sp._thr_sq(P3P_THRESHOLD), 1.0,
            sw.draw_seeds(0, spl.N_SEEDS), 1 << 20, spl.BLOCK_H)
    out[9] = (row9, spl._sweep_plain(*row9)[:2])
    shares[9] = spl.valid_root_share(0, XL, pixL, torch.ones(256, device="cuda"), 1 << 20)
    return out, shares


def caller(lib, row, args):
    """One call of ``lib``'s entry of ``row`` on ``args`` -> (f [4, B], i [2, B])."""
    entry = getattr(lib, ENTRIES[row])
    stream = torch.cuda.current_stream().cuda_stream
    n_hyp = args[-2] if row in (5, 9) else args[6]
    B = n_hyp // 8
    f = torch.empty((4, B), dtype=torch.float32, device="cuda")
    i = torch.empty((2, B), dtype=torch.int32, device="cuda")
    if row == 5:
        X, fb, pix, mask, thr_sq, ay, seeds, n_points, n_score, _, block_h = args
        vmask = sw.sample_bitmask(mask)
        keep = (vmask,)
        ptrs = (X.data_ptr(), fb.data_ptr(), pix.data_ptr(), mask.data_ptr(),
                vmask.data_ptr(), thr_sq, ay, *seeds, n_points, n_score, n_hyp, block_h, 0)
    elif row == 9:
        X, pix, mask, thr_sq, ay, seeds, _, block_h = args
        prep = torch.empty((spl.PREP_FLOATS,), dtype=torch.float32, device="cuda")
        aux = torch.empty((X.shape[0] + 1,), dtype=torch.int32, device="cuda")
        keep = (prep, aux)
        ptrs = (X.data_ptr(), pix.data_ptr(), mask.data_ptr(), thr_sq, ay, *seeds,
                X.shape[0], n_hyp, block_h, *((0,) if lib.row9_full_arg else ()),
                prep.data_ptr(), aux.data_ptr())
    else:
        a, b, mask, thr, seeds, n_points, _, *block = args
        prep = torch.empty((se.PREP_FLOATS,), dtype=torch.float32, device="cuda")
        keep = (prep,)
        ptrs = (a.data_ptr(), b.data_ptr(), mask.data_ptr(), float(thr), *seeds, n_points,
                a.shape[0], n_hyp, *block, 0, prep.data_ptr())

    def call():  # ``keep`` holds the buffers behind ``ptrs``
        err = entry(*ptrs, f.data_ptr(), i.data_ptr(), stream) if keep else 1
        if err:
            raise RuntimeError(f"{ENTRIES[row]} failed: CUDA error {err}")
        return f, i
    return call


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
    with ThreadPoolExecutor(len(trees)) as pool:  # every nvcc at once
        built = list(pool.map(lambda k: build(Path(trees[k]), _build.BUILD_DIR.parent
                                              / "sweep_ab" / str(k)), range(len(trees))))
    libs = [lib for lib, _ in built]
    results = [{"tree": tree, **info} for tree, (_, info) in zip(trees, built)]
    rows, shares = cases()
    for row, (args, (f_p, i_p)) in rows.items():
        calls = [caller(lib, row, args) for lib in libs]
        for res, call in zip(results, calls):
            f_k, i_k = call()
            res[f"row{row}"] = {
                "equal": bool(torch.equal(f_k, f_p) and torch.equal(i_k, i_p)),
                "counts_equal_fraction": float((f_k[1::2] == f_p[1::2]).double().mean())}
            if row in shares:
                res[f"row{row}"]["valid_share"] = shares[row]
        torch.cuda.synchronize()
        times = [[] for _ in calls]
        for r in range(ROUNDS):
            order = range(len(calls)) if r % 2 == 0 else reversed(range(len(calls)))
            for k in order:
                times[k].append(events_ms(calls[k]))
        symbol = ENTRIES[row].removesuffix("_launch")
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
