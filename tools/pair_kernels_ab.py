#!/usr/bin/env python3
"""The pair-count kernels against an earlier version of their source, on
one card.

    python3 tools/pair_kernels_ab.py OLD_PAIR_COUNTS_CU

``OLD_PAIR_COUNTS_CU`` is ``csrc/pair_counts.cu`` as it was before the
minimum image lost its division and the forward kept its row sums (its C
interface: ``pair_counts_fwd`` and ``pair_counts_bwd`` without ``thr``
and ``rows``), for example ``git show
5275be5:multigrad_tpu_torch/csrc/pair_counts.cu``.  It is built with the
package's ``nvcc`` flags beside ``csrc/erf_common.cuh`` under
``build/pair_kernels_ab/``.  Needs one NVIDIA GPU.

On galaxy mocks of 100,003 halos (projected r_p in a 250 Mpc/h box with
pimax 20, the wp(rp) bins; 3D in a 75 Mpc/h box, with and without the box,
and with an edge at 0) and on 20,003 positions spread over [-60, 160]^3
in a 100 box (every pair takes the division), it checks that the counts
equal the old kernel's bit for bit, and that dw1 from the row sums
(``pair_rowgrad``) and from the sweep match the old backward within rtol
1e-3, atol 1e-5·max|dw|.  Then it times the old and the new kernels at
the wp(rp) path's shape, 1e5 and 1e6 halos, in turns (old, new, new, old;
CUDA events, median).  Prints one line per check and per time; exits
non-zero if a check fails.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD_FWD = "pair_counts_fwd"
OLD_BWD = "pair_counts_bwd"


def build_old(source):
    """Compile the old source into build/pair_kernels_ab/ and load it with
    its own C interface."""
    from multigrad_tpu_torch.ops import cuda_build
    out = os.path.join(HERE, "build", "pair_kernels_ab")
    os.makedirs(out, exist_ok=True)
    shutil.copy(source, os.path.join(out, "pair_counts_old.cu"))
    shutil.copy(cuda_build.CSRC / "erf_common.cuh", out)
    lib_path = os.path.join(out, "libpair_counts_old.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(out, "pair_counts_old.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    getattr(lib, OLD_FWD).argtypes = [p, p, i64, p, p, i64, p, i32, f32, i32,
                                      f32, i32, p, i32, p, p]
    getattr(lib, OLD_BWD).argtypes = [p, i64, p, p, i64, p, i32, p, f32, i32,
                                      f32, i32, p, i32, p]
    getattr(lib, OLD_FWD).restype = ctypes.c_int
    getattr(lib, OLD_BWD).restype = ctypes.c_int
    return lib


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("pair_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from multigrad_tpu_torch.models import make_galaxy_mock, selection_weights
    from multigrad_tpu_torch.models.wprp import TRUTH
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import pair_kernels as pk

    dev = torch.device("cuda")
    old = build_old(argv[1])
    failed = []

    def geometry(box, pimax):
        return (0.0 if box is None else float(box), int(box is not None),
                0.0 if pimax is None else float(pimax),
                int(pimax is not None))

    def old_fwd(p1, w1, p2, w2, esq, box, pimax):
        grid = cuda_build.row_blocks(p1.shape[0])
        part = torch.empty((grid, esq.shape[0] - 1), device=dev)
        counts = torch.empty(esq.shape[0] - 1, device=dev)
        code = getattr(old, OLD_FWD)(
            p1.data_ptr(), w1.data_ptr(), p1.shape[0], p2.data_ptr(),
            w2.data_ptr(), p2.shape[0], esq.data_ptr(), esq.shape[0],
            *geometry(box, pimax), part.data_ptr(), grid, counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        cuda_build.raise_on(code, "old pair_counts_fwd")
        return counts

    def old_bwd(p1, p2, w2, esq, g, box, pimax):
        dw = torch.empty(p1.shape[0], device=dev)
        code = getattr(old, OLD_BWD)(
            p1.data_ptr(), p1.shape[0], p2.data_ptr(), w2.data_ptr(),
            p2.shape[0], esq.data_ptr(), esq.shape[0], g.data_ptr(),
            *geometry(box, pimax), dw.data_ptr(),
            cuda_build.row_blocks(p1.shape[0]),
            torch.cuda.current_stream().cuda_stream)
        cuda_build.raise_on(code, "old pair_counts_bwd")
        return dw

    def mock(n, box, seed):
        pos, logm = make_galaxy_mock(n, box, seed=seed, device=dev)
        return pos, selection_weights(logm, TRUTH).contiguous()

    def close(label, got, want):
        scale = float(want.abs().max())
        excess = float(((got - want).abs() - 1e-3 * want.abs()).max())
        if excess > 1e-5 * scale:
            failed.append(label)
        return float((got - want).abs().max()) / scale

    wp_edges = torch.logspace(-0.5, 1.2, 9, device=dev)
    xi_edges = torch.logspace(-0.3, 1.1, 8, device=dev)
    p250, w250 = mock(100_003, 250.0, 12)
    p75, w75 = mock(100_003, 75.0, 14)
    gen = torch.Generator(device=dev).manual_seed(6)
    p_out = torch.rand((20_003, 3), generator=gen, device=dev) * 220.0 - 60.0
    w_out = torch.rand(20_003, generator=gen, device=dev) + 0.2
    cases = (
        ("projected, box 250", p250, w250, wp_edges, 250.0, 20.0),
        ("3D, box 75", p75, w75, xi_edges, 75.0, None),
        ("3D, no box", p75, w75, xi_edges, None, None),
        ("3D, box 75, edges from 0", p75, w75,
         torch.tensor([0.0, 1.0, 4.0], device=dev), 75.0, None),
        ("outside the box, box 100", p_out, w_out, xi_edges, 100.0, None))
    for label, p, w, edges, box, pimax in cases:
        esq = (edges * edges).contiguous()
        g = torch.linspace(-1.0, 2.0, esq.shape[0] - 1, device=dev)
        new, rows = pk.pair_counts_fwd_cuda(p, w, p, w, esq, box, pimax,
                                            rows=True)
        ref = old_fwd(p, w, p, w, esq, box, pimax)
        ref_dw = old_bwd(p, p, w, esq, g, box, pimax)
        same = torch.equal(new, ref)
        if not same:
            failed.append(f"{label}: counts")
        row_err = close(f"{label}: pair_rowgrad",
                        pk.pair_rowgrad_cuda(rows, g), ref_dw)
        sweep_err = close(f"{label}: sweep", pk.pair_counts_bwd_cuda(
            p, p, w, esq, g, box, pimax), ref_dw)
        print(f"{label}: counts equal the old kernel's bit for bit: {same}; "
              f"dw1 against the old backward, max|err|/max|dw|: "
              f"pair_rowgrad {row_err:.3e}, sweep {sweep_err:.3e}",
              flush=True)
    del p250, w250, p75, w75, p_out, w_out

    def time_ms(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times)

    esq = (wp_edges * wp_edges).contiguous()
    g = torch.linspace(-1.0, 2.0, 8, device=dev)
    for n, reps in ((100_000, 10), (1_000_000, 2)):
        p, w = mock(n, 250.0, 15)
        _, rows = pk.pair_counts_fwd_cuda(p, w, p, w, esq, 250.0, 20.0,
                                          rows=True)
        runs = {
            "old forward": lambda: old_fwd(p, w, p, w, esq, 250.0, 20.0),
            "new forward": lambda: pk.pair_counts_fwd_cuda(
                p, w, p, w, esq, 250.0, 20.0, rows=True),
            "old backward": lambda: old_bwd(p, p, w, esq, g, 250.0, 20.0),
            "new sweep": lambda: pk.pair_counts_bwd_cuda(
                p, p, w, esq, g, 250.0, 20.0),
        }
        times = {k: [] for k in runs}
        for order in (("old", "new"), ("new", "old")):
            for side in order:
                for name, fn in runs.items():
                    if name.startswith(side):
                        times[name].append(time_ms(fn, reps))
        row_ms = time_ms(lambda: pk.pair_rowgrad_cuda(rows, g), 50)
        print(f"{n:,} halos, wp(rp) shape, ms (old, new, new, old turns): "
              + "; ".join(f"{k} {v}" for k, v in times.items())
              + f"; pair_rowgrad {row_ms:.4f}", flush=True)
    if failed:
        print(f"pair_kernels_ab: FAILED {failed}", flush=True)
        return 1
    print("pair_kernels_ab: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
