"""Time the redesigned kernels of the PyTorch/CUDA port (kernel rows 1-9:
``sweep_multi.cu``, ``sweep.cu``, ``score.cu`` (rows 3 and 4),
``sweep_pnp.cu``, ``sweep_large.cu``, ``sweep_essential.cu``,
``sweep_essential_large.cu`` and ``sweep_pnp_large.cu``) from several
source trees in turns on one card, and count their SASS instructions by
class.

    python tools/sweep_ab.py [--rows 3,4] DIR [DIR ...]  # from the repository root

Each DIR holds those eight sources and their headers: a copy of
``ransac_tpu_torch/csrc/`` as some commit has it, or the checkout's own.
Older trees are called with their own entry signatures, detected from the
source: a ``sweep_pnp_large.cu``, ``sweep_large.cu``,
``sweep_essential_large.cu`` or ``sweep_multi.cu`` without a ``full``
argument is called without it, a ``score.cu`` whose homography or
pose entry takes no point count gets that row's points padded to 16, and
a ``score.cu`` or ``sweep_pnp.cu`` without the pointers that may stand in
for the threshold (and row 5's y-scale) is called without them; newer
trees get null pointers, so every tree takes the floats by value.

The trees are built at once with the port's nvcc flags (``ops/_build.py``)
into ``build/sweep_ab/<k>/``, ptxas's registers and spills are read, and
``cuobjdump -sass`` gives the static instructions of each kernel by class.

Row 1 runs on the planted 458-candidate scenes of chip_smoke.py at 13 and
16 points (``sweep_multi_cases``; 1024 and 2048 samples), row 8 on the
two-view pool of chip_smoke.py's main path (``twoview_pool``: 1024 match
slots of the rendered pair) at 8192 hypotheses, row 2 on the bench problem
(``bench.problem``, 13 points) at 2^22 hypotheses, row 7 on 16 uniform
random correspondences at 2^20, row 5 on 13 uniform random 3D-2D
correspondences at 2^20 and row 9 on 256 at 2^20
(``cli profile``'s kind of rows: ``numpy.random.default_rng(0)``, 30 px at
f = 900), row 6 on chip_smoke.py's planted pools of 1024 and 256 points at
2^20, row 3 on homographies of random 4-point samples of the bench problem
at 2^18 and 2^20 (chip_smoke.py's ``score_models``), row 4 on P3P poses
of random 3-point samples of chip_smoke.py's planted 13-point PnP scene
(``pose_models``, ``pnp_inputs``) at 2^20 and at the 12 poses that
``ransac_pnp_sweep`` re-scores; reduced records (rows 3 and 4: counts and
MSAC).  Each tree's outputs there are compared with the
plain versions (bit for bit, and the fraction of equal counts), and rows 5
and 9 carry the share of valid (sample, root) pairs of their inputs.
Timing: the trees in turns (A B C, then C B A, ...), 6 rounds; in each
round, CUDA events around 50 calls (prep + kernel) of each tree, then the
mean device time of each of its kernels over 50 calls under
torch.profiler.  Each case prints every round's numbers and their
medians.  Prints one JSON line per tree with the card's name and power
limit.  Needs a card, nvcc and cuobjdump.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from ransac_tpu_torch import bench  # noqa: E402
from ransac_tpu_torch.utils.config import LocalizeConfig  # noqa: E402
from ransac_tpu_torch.io.synthetic import planted_homography_pool  # noqa: E402
from ransac_tpu_torch.ops import _build  # noqa: E402
from ransac_tpu_torch.ops import score as sc  # noqa: E402
from ransac_tpu_torch.ops import sweep as sw  # noqa: E402
from ransac_tpu_torch.ops import sweep_essential as se  # noqa: E402
from ransac_tpu_torch.ops import sweep_essential_large as sel  # noqa: E402
from ransac_tpu_torch.ops import sweep_large as sl  # noqa: E402
from ransac_tpu_torch.ops import sweep_multi as sm  # noqa: E402
from ransac_tpu_torch.ops import sweep_pnp as sp  # noqa: E402
from ransac_tpu_torch.ops import sweep_pnp_large as spl  # noqa: E402
from ransac_tpu_torch.profile import ESSENTIAL_THRESHOLD  # noqa: E402

KERNELS = {"sweep.cu": ["sweep_kernel"], "sweep_essential.cu": ["sweep_essential_kernel"],
           "sweep_pnp.cu": ["sweep_pnp_kernel"],
           "sweep_pnp_large.cu": ["sweep_pnp_large_kernel"],
           "sweep_large.cu": ["sweep_large_kernel"],
           "score.cu": ["homography_scores_kernel", "pnp_scores_kernel"],
           "sweep_multi.cu": ["sweep_multi_kernel"],
           "sweep_essential_large.cu": ["sweep_essential_large_kernel"]}
ENTRIES = {2: "sweep_launch", 7: "sweep_essential_launch", 5: "sweep_pnp_launch",
           9: "sweep_pnp_large_launch", 6: "sweep_large_launch",
           3: "homography_scores_launch", 4: "pnp_scores_launch", 1: "sweep_multi_launch",
           8: "sweep_essential_large_launch"}
ARGTYPES = dict(_build.KERNELS.values())  # {C entry: the current tree's argtypes}
CLASSES = ("FFMA", "FMUL", "FADD", "IMAD", "LDS", "SHFL", "MUFU")
ROUNDS, CALLS = 6, 50
P3P_THRESHOLD = 30.0 / 900.0


def build(tree: Path, work: Path) -> tuple[ctypes.CDLL, dict]:
    """Compile and link the kernels of ``tree``: the bound library and
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
    for src, kernels in KERNELS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(objs[src])], check=True,
                              capture_output=True, text=True).stdout
        for kernel in kernels:
            info[kernel] = {**ptxas_of(reports[src], kernel),
                            "sass": sass_classes(sass, kernel)}
    lib = ctypes.CDLL(str(lib_path))
    lib.row9_full_arg = "int block_h, int full" in (tree / "sweep_pnp_large.cu").read_text()
    lib.row6_full_arg = "int n_hyp, int full" in (tree / "sweep_large.cu").read_text()
    score_cu = (tree / "score.cu").read_text()
    lib.row3_raw_points = (re.search(r"homography_scores_launch\([^)]*int n, int H", score_cu)
                           is not None)
    lib.scores_thr_p = "const float* thr_sq_p" in score_cu
    lib.row5_thr_p = "const float* thr_sq_p" in (tree / "sweep_pnp.cu").read_text()
    lib.row4_raw_points = re.search(r"pnp_scores_launch\([^)]*int n, int H", score_cu) is not None
    lib.row8_full_arg = ("int block_h, int full"
                         in (tree / "sweep_essential_large.cu").read_text())
    lib.row1_full_arg = "int n, int full" in (tree / "sweep_multi.cu").read_text()
    older = {"sweep_pnp_large_launch": not lib.row9_full_arg,
             "sweep_large_launch": not lib.row6_full_arg,
             "homography_scores_launch": not lib.row3_raw_points,
             "pnp_scores_launch": not lib.row4_raw_points,
             "sweep_essential_large_launch": not lib.row8_full_arg,
             "sweep_multi_launch": not lib.row1_full_arg}
    without_p = {"homography_scores_launch": not lib.scores_thr_p,
                 "pnp_scores_launch": not lib.scores_thr_p,
                 "sweep_pnp_launch": not lib.row5_thr_p}
    for fn in ENTRIES.values():
        argtypes = list(ARGTYPES[fn])
        if without_p.get(fn):  # the pointers after the floats are the newer trees'
            first = argtypes.index(ctypes.c_float)
            n_f = 2 if fn == "sweep_pnp_launch" else 1
            del argtypes[first + n_f:first + 2 * n_f]
        if older.get(fn):  # the extra int argument is the newer trees'
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
            inside = re.search(rf"\d{kernel}[EI]", m[1]) is not None
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
            inside = re.search(rf"\d{kernel}[EI]", line) is not None
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


def cases(rows):
    """{case: (row, arguments, plain outputs (f, i))} of the kernel rows
    ``rows``, and for rows 5 and 9 {case: the share of valid (sample, root)
    pairs} (``valid_root_share``).  The f of rows 3 and 4 is (msac, counts)
    [2, H] and their i is empty; row 1's f is (msac, counts) [2, C] and its i the
    packed samples [C]."""
    src, dst, mask = bench.problem("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")
    x1, x2 = (t(rng.uniform(-0.5, 0.5, (16, 2))) for _ in range(2))
    row2 = (src, dst, mask, 75.0, sw.draw_seeds(5, 4), 13, 1 << 22)
    row7 = (x1, x2, torch.ones(16, device="cuda"), ESSENTIAL_THRESHOLD,
            sw.draw_seeds(0, 8), 16, 1 << 20, se.BLOCK_H)
    out = {}
    if 2 in rows:
        msac, counts, i = sw._sweep_plain(*row2, False)
        out["row2"] = (2, row2, (torch.stack([msac[0], counts[0], msac[1], counts[1]]), i))
    if 7 in rows:
        out["row7"] = (7, row7, se._sweep_plain(*row7, False))
    X, pixn = t(rng.uniform(-2, 2, (13, 3))), t(rng.uniform(-0.5, 0.5, (13, 2)))
    row5 = (*sp.prepare(X, pixn, torch.ones(13, device="cuda"), P3P_THRESHOLD, 1.0),
            sw.draw_seeds(0, 3), 13, 13, 1 << 20, sp.BLOCK_H)
    shares = {}
    if 5 in rows:
        out["row5"] = (5, row5, sp._sweep_plain(*row5, False))
        shares["row5"] = sp.valid_root_share(0, X, pixn, torch.ones(13, device="cuda"),
                                             P3P_THRESHOLD, 1 << 20, block_h=sp.BLOCK_H)
    XL, pixL = t(rng.uniform(-2, 2, (256, 3))), t(rng.uniform(-0.5, 0.5, (256, 2)))
    row9 = (XL, pixL, torch.ones(256, device="cuda"), spl._thr_sq(P3P_THRESHOLD), 1.0,
            sw.draw_seeds(0, spl.N_SEEDS), 1 << 20, spl.BLOCK_H)
    if 9 in rows:
        out["row9"] = (9, row9, spl._sweep_plain(*row9)[:2])
        shares["row9"] = spl.valid_root_share(0, XL, pixL, torch.ones(256, device="cuda"),
                                              1 << 20)
    for n in (1024, 256) if 6 in rows else ():  # chip_smoke.py's timed pools
        a, b, _ = planted_homography_pool(n, seed=7)
        row6 = (t(a), t(b), torch.ones(n, device="cuda"), 3.0, sw.draw_seeds(0, 6), 1 << 20)
        out[f"row6_n{n}"] = (6, row6, sl._sweep_plain(*row6)[:2])
    if 8 in rows:
        x1, x2, emask, thr_sq = chip_smoke.twoview_pool("cuda")
        row8 = (x1, x2, emask, thr_sq, sw.draw_seeds(0, sel.N_SEEDS), 8192, sel.BLOCK_H)
        out[f"row8_twoview1024_H8192_nvalid{int(emask.sum())}"] = (
            8, row8, sel._sweep_plain(*row8)[:2])
    thr = LocalizeConfig().ransac.threshold
    with tempfile.TemporaryDirectory() as tmp:
        multi = chip_smoke.sweep_multi_cases(tmp, "cuda") if 1 in rows else {}
    for name, shape in (("n13", "C458_n13_H1024"), ("n16", "C458_n16_H2048")) if multi else ():
        pos2, dst, mask, idx = multi[name]
        row1 = sm._normalize(pos2, dst, mask, thr)[:4] + (idx, dst.shape[0])
        m, c, p = sm._sweep_plain(*row1)
        out[f"row1_{shape}"] = (1, row1, (torch.stack([m, c]), p))
    for log_h in (18, 20) if 3 in rows else ():
        models, s3, d3, m3 = chip_smoke.score_models(1 << log_h, "cuda", seed=1)
        row3 = (models.reshape(-1, 9).contiguous(), s3, d3, m3, sc._thr_sq(75.0))
        c, m = sc._h_plain(*row3)
        out[f"row3_H2^{log_h}"] = (3, row3, (torch.stack([m, c]), torch.zeros(0)))
    if 4 in rows:
        with tempfile.TemporaryDirectory() as tmp:
            ps, scene = chip_smoke.load_scene(Path(tmp) / "pnp13", "cuda", seed=0)
        X, _, _, pmask, pix_n, thr_n, _ = chip_smoke.pnp_inputs(ps, scene)
        for n_poses, shape in ((1 << 20, "H2^20"), (12, "H12")):
            row4 = (chip_smoke.pose_models(n_poses, X, pix_n), X, pix_n, pmask,
                    sc._thr_sq(thr_n))
            c, m = sc._pnp_plain(*row4)
            out[f"row4_n13_{shape}"] = (4, row4, (torch.stack([m, c]), torch.zeros(0)))
    return out, shares


def caller(lib, row, args):
    """One call of ``lib``'s entry of ``row`` on ``args`` -> (f, i) as
    ``cases`` gives the plain outputs."""
    entry = getattr(lib, ENTRIES[row])
    stream = torch.cuda.current_stream().cuda_stream
    if row in (3, 4):
        models, src, dst, mask, thr_sq = args
        H = models.shape[0]
        f = torch.empty((2, H), dtype=torch.float32, device="cuda")
        i = torch.zeros(0)
        if lib.row3_raw_points if row == 3 else lib.row4_raw_points:
            keep = (src, dst, mask)
            ptrs = (models.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
                    thr_sq, *((None,) if lib.scores_thr_p else ()), src.shape[0], H,
                    f[1].data_ptr(), f[0].data_ptr())
        else:  # the 16 padded points of the older entry
            src_p, mask_p = sc._pad_points(src, mask, src.shape[1])
            dst_p, _ = sc._pad_points(dst, mask, 2)
            keep = (src_p, dst_p, mask_p)
            ptrs = (models.data_ptr(), src_p.data_ptr(), dst_p.data_ptr(),
                    mask_p.data_ptr(), thr_sq, *((None,) if lib.scores_thr_p else ()), H,
                    f[1].data_ptr(), f[0].data_ptr())

        def call_scores():  # ``keep`` holds the buffers behind ``ptrs``
            err = entry(*ptrs, stream) if keep else 1
            if err:
                raise RuntimeError(f"{ENTRIES[row]} failed: CUDA error {err}")
            return f, i
        return call_scores
    if row == 1:
        src_p, dst_p, mask_p, thr_t, idx, n = args
        C, H = src_p.shape[0], idx.shape[1]
        f = torch.empty((2, C), dtype=torch.float32, device="cuda")
        i = torch.empty((C,), dtype=torch.int32, device="cuda")
        ptrs = (src_p.data_ptr(), dst_p.data_ptr(), mask_p.data_ptr(), thr_t.data_ptr(),
                idx.data_ptr(), C, H, n, *((0,) if lib.row1_full_arg else ()),
                f[0].data_ptr(), f[1].data_ptr(), i.data_ptr())

        def call_multi():  # ``args`` holds the buffers behind ``ptrs``
            err = entry(*ptrs, stream) if args else 1
            if err:
                raise RuntimeError(f"{ENTRIES[row]} failed: CUDA error {err}")
            return f, i
        return call_multi
    n_hyp = (args[-2] if row in (5, 9) else args[-1] if row == 6
             else args[5] if row == 8 else args[6])
    B = n_hyp // 8
    f = torch.empty((4, B), dtype=torch.float32, device="cuda")
    i = torch.empty((2, B), dtype=torch.int32, device="cuda")
    if row == 5:
        X, fb, pix, mask, thr_sq, ay, seeds, n_points, n_score, _, block_h = args
        vmask = sw.sample_bitmask(mask)
        keep = (vmask,)
        ptrs = (X.data_ptr(), fb.data_ptr(), pix.data_ptr(), mask.data_ptr(),
                vmask.data_ptr(), thr_sq, ay, *((None, None) if lib.row5_thr_p else ()),
                *seeds, n_points, n_score, n_hyp, block_h, 0)
    elif row == 9:
        X, pix, mask, thr_sq, ay, seeds, _, block_h = args
        prep = torch.empty((spl.PREP_FLOATS,), dtype=torch.float32, device="cuda")
        aux = torch.empty((X.shape[0] + 1,), dtype=torch.int32, device="cuda")
        keep = (prep, aux)
        ptrs = (X.data_ptr(), pix.data_ptr(), mask.data_ptr(), thr_sq, ay, *seeds,
                X.shape[0], n_hyp, block_h, *((0,) if lib.row9_full_arg else ()),
                prep.data_ptr(), aux.data_ptr())
    elif row == 6:
        src, dst, mask, thr, seeds, _ = args
        prep = torch.empty((sl.PREP_FLOATS,), dtype=torch.float32, device="cuda")
        aux = torch.empty((src.shape[0] + 1,), dtype=torch.int32, device="cuda")
        keep = (prep, aux)
        ptrs = (src.data_ptr(), dst.data_ptr(), mask.data_ptr(), float(thr), *seeds,
                src.shape[0], n_hyp, *((0,) if lib.row6_full_arg else ()),
                prep.data_ptr(), aux.data_ptr())
    elif row == 8:
        x1, x2, mask, thr_sq, seeds, _, block_h = args
        prep = torch.empty((sel.PREP_FLOATS + 10 * n_hyp,), dtype=torch.float32,
                           device="cuda")  # room for the solves of trees that keep them
        aux = torch.empty((x1.shape[0] + 1,), dtype=torch.int32, device="cuda")
        keep = (prep, aux)
        ptrs = (x1.data_ptr(), x2.data_ptr(), mask.data_ptr(), float(thr_sq), *seeds,
                x1.shape[0], n_hyp, block_h, *((0,) if lib.row8_full_arg else ()),
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


def device_us(call, symbols, reps=CALLS) -> dict:
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
        evs = [ev for ev in prof.key_averages()
               if re.search(rf"(::|\d){symbol}(\(|E|<|I)", ev.key)]
        total = sum(getattr(ev, "device_time_total", 0.0) for ev in evs)
        count = sum(ev.count for ev in evs)
        out[symbol] = total / count if count and total > 0 else None
    return out


def symbols_of(row) -> list[str]:
    """The kernels of a row's call: its main kernel, then its prep kernel
    (row 8: then its solve kernel, where the tree has one)."""
    symbol = ENTRIES[row].removesuffix("_launch")
    if row in (1, 3, 4):
        return [f"{symbol}_kernel"]
    return [f"{symbol}_kernel", f"{symbol}_prep_kernel",
            *([f"{symbol}_solve_kernel"] if row == 8 else [])]


def main(trees: list[str]) -> int:
    rows = set(ENTRIES)
    if trees[:1] == ["--rows"] and len(trees) > 1:
        rows = {int(r) for r in trees[1].split(",")}
        trees = trees[2:]
    if not trees or not torch.cuda.is_available():
        print("usage: python tools/sweep_ab.py [--rows 3,4] DIR [DIR ...] (needs a CUDA "
              "device)", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(trees)) as pool:  # every nvcc at once
        built = list(pool.map(lambda k: build(Path(trees[k]), _build.BUILD_DIR.parent
                                              / "sweep_ab" / str(k)), range(len(trees))))
    libs = [lib for lib, _ in built]
    results = [{"tree": tree, **info} for tree, (_, info) in zip(trees, built)]
    all_cases, shares = cases(rows)
    for name, (row, args, (f_p, i_p)) in all_cases.items():
        calls = [caller(lib, row, args) for lib in libs]
        for res, call in zip(results, calls):
            f_k, i_k = call()
            res[name] = {
                "equal": bool(torch.equal(f_k, f_p) and torch.equal(i_k.cpu(), i_p.cpu())),
                "counts_equal_fraction": float((f_k[1::2] == f_p[1::2]).double().mean())}
            if name in shares:
                res[name]["valid_share"] = shares[name]
        torch.cuda.synchronize()
        symbols = symbols_of(row)
        times = [[] for _ in calls]
        device = [{s: [] for s in symbols} for _ in calls]
        for r in range(ROUNDS):
            order = range(len(calls)) if r % 2 == 0 else reversed(range(len(calls)))
            for k in order:
                times[k].append(events_ms(calls[k]))
                for symbol, us in device_us(calls[k], symbols).items():
                    device[k][symbol].append(us)
        for res, ms, dev in zip(results, times, device):
            res[name].update(ms_median=statistics.median(ms), ms_all=ms)
            for symbol, us in dev.items():
                known = [u for u in us if u is not None]
                res[name][f"{symbol}_device_us_all"] = us
                res[name][f"{symbol}_device_us_median"] = (
                    statistics.median(known) if known else None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    for res in results:
        print(json.dumps({**res, "gpu": smi.stdout.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
