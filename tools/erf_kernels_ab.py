#!/usr/bin/env python3
"""The dense erf-CDF kernels against an earlier version of their source,
on one card.

    python3 tools/erf_kernels_ab.py OLD_ERF_COUNTS_CU

``OLD_ERF_COUNTS_CU`` is ``csrc/erf_counts.cu`` as it was before each call
became one launch (its C interface: ``erf_counts_fwd`` with a partials
buffer and a second ``sum_rows_kernel`` launch, ``erf_counts_bwd`` taking
``h`` and returning raw sums), for example ``git show
0a92be5:multigrad_tpu_torch/csrc/erf_counts.cu``.  It is built with the
package's ``nvcc`` flags beside ``csrc/erf_common.cuh`` under
``build/erf_kernels_ab/`` and driven as its wrappers drove it: their grid
(:func:`parent_grid`), ``h`` from ``g`` (``_h_from_g``) before the backward
and the factors of ``_scale_grads`` (scalar sigma) or ``h · rows`` (a
per-particle sigma) after it.  Needs one NVIDIA GPU.

At the two launch shapes of the models (the SMF's 1e8 halos, 11 edges
and a scalar sigma; a history chunk's 1e6 halos, 14 edges and a
per-particle sigma), and on a ragged 1,000,003 halos with 1,000 ``+inf``
of each kind, it checks that the counts and the three gradients match
the old ones within the plain versions' tolerances (counts 2e-5·max|count|,
gradients rtol 1e-3 with atol 1e-5·max|grad|).  Then it times old and new
in turns (old, new, new, old): the median of CUDA-event runs with the
wrapper, and the device time per call (all kernels of the call) from the
torch profiler.  Last, it times the new kernels' device time per launch
at grids of 1 to 16 blocks an SM, at one block per 1,024 and per 4,096
particles, against the grid that
:func:`multigrad_tpu_torch.ops.erf_kernels.erf_grid` picks.
Prints one line per check and per time; exits non-zero if a check fails.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COT = [float(i) for i in range(10)]


def parent_grid(n, device):
    """The old kernels' grid: one block per 256 particles, at most 8 an
    SM."""
    import torch
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // 256), sms * 8))


def build_old(source):
    """Compile the old source into build/erf_kernels_ab/ and load it with
    its own C interface."""
    from multigrad_tpu_torch.ops import cuda_build
    out = os.path.join(HERE, "build", "erf_kernels_ab")
    os.makedirs(out, exist_ok=True)
    shutil.copy(source, os.path.join(out, "erf_counts_old.cu"))
    shutil.copy(cuda_build.CSRC / "erf_common.cuh", out)
    lib_path = os.path.join(out, "liberf_counts_old.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(out, "erf_counts_old.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.erf_counts_fwd.argtypes = [p, i64, p, i32, p, i32, p, i32, p, p]
    lib.erf_counts_bwd.argtypes = [p, i64, p, i32, p, i32, p, p, p, p, i32,
                                   p, p]
    lib.erf_counts_fwd.restype = lib.erf_counts_bwd.restype = ctypes.c_int
    return lib


def device_ms(fn, calls):
    """Device ms per call of ``fn`` (every kernel it launches) and of its
    kernels named ``erf_*_kernel`` alone, from a torch profiler window of
    ``calls`` calls; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = erf = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            total += us
            if "erf_fwd_kernel" in evt.name or "erf_bwd_kernel" in evt.name:
                erf += us
    if not total:
        return None, None
    return total / calls / 1e3, erf / calls / 1e3


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("erf_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 1
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from multigrad_tpu_torch.models import make_smf_data
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import erf_kernels as ek

    dev = torch.device("cuda")
    old = build_old(argv[1])
    failed = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_fwd(v, e, s):
        vec = s.dim() > 0
        grid = parent_grid(v.shape[0], dev)
        part = torch.empty((grid, e.shape[0] - 1), device=dev)
        counts = torch.empty(e.shape[0] - 1, device=dev)
        code = old.erf_counts_fwd(v.data_ptr(), v.shape[0], e.data_ptr(),
                                  e.shape[0], s.data_ptr(), int(vec),
                                  part.data_ptr(), grid, counts.data_ptr(),
                                  stream())
        cuda_build.raise_on(code, "old erf_counts_fwd")
        return counts

    def old_bwd(v, e, s, g):
        vec = s.dim() > 0
        n, n_edges = v.shape[0], e.shape[0]
        h = ek._h_from_g(g.to(torch.float32)).contiguous()
        cols = n_edges if vec else n_edges + 1
        grid = parent_grid(n, dev)
        dv = torch.empty_like(v)
        ds = torch.empty_like(v) if vec else None
        part = torch.empty((grid, cols), device=dev)
        sums = torch.empty(cols, device=dev)
        code = old.erf_counts_bwd(v.data_ptr(), n, e.data_ptr(), n_edges,
                                  s.data_ptr(), int(vec), h.data_ptr(),
                                  dv.data_ptr(),
                                  None if ds is None else ds.data_ptr(),
                                  part.data_ptr(), grid, sums.data_ptr(),
                                  stream())
        cuda_build.raise_on(code, "old erf_counts_bwd")
        if vec:
            return dv, ek._INV_SQRT_PI * h * sums, ds
        return ek._scale_grads(dv, sums[:n_edges], sums[n_edges], h,
                               s.reshape(()))

    def new_fwd(v, e, s):
        if s.dim():
            return ek.erf_counts_fwd_vec_cuda(v, e, s)
        return ek.erf_counts_fwd_cuda(v, e, s.reshape(1))

    def new_bwd(v, e, s, g):
        if s.dim():
            return ek.erf_counts_bwd_vec_cuda(v, e, s, g)
        return ek.erf_counts_bwd_cuda(v, e, s.reshape(1), g)

    def compare(label, v, e, s, g):
        fwd, ref = new_fwd(v, e, s), old_fwd(v, e, s)
        fwd_err = float((fwd - ref).abs().max())
        if fwd_err > 2e-5 * float(ref.abs().max()):
            failed.append(f"{label}: counts")
        errs = []
        for name, a, b in zip(("dvalues", "dedges", "dsigma"),
                              new_bwd(v, e, s, g), old_bwd(v, e, s, g)):
            scale = float(b.abs().max())
            excess = float(((a - b).abs() - 1e-3 * b.abs()).max())
            if not bool(torch.isfinite(a).all()) or excess > 1e-5 * scale:
                failed.append(f"{label}: {name}")
            errs.append(float((a - b).abs().max()) / scale)
        print(f"{label}: counts against the old kernel max|err| "
              f"{fwd_err:.3e} (counts up to {float(ref.abs().max()):.6g}); "
              f"gradients max|err|/max|grad| dvalues {errs[0]:.3e}, dedges "
              f"{errs[1]:.3e}, dsigma {errs[2]:.3e}", flush=True)

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

    gen = torch.Generator(device=dev).manual_seed(7)

    def hist_inputs(n):
        v = 9.4 + 0.9 * torch.randn(n, generator=gen, device=dev)
        return v, 0.1 + 0.3 * torch.rand(n, generator=gen, device=dev)

    smf_edges = torch.linspace(9, 10, 11, device=dev)
    hist_edges = torch.linspace(7.0, 11.75, 14, device=dev)
    hcot = torch.randn(13, generator=gen, device=dev)
    cot = torch.tensor(COT, device=dev)

    v, sig = hist_inputs(1_000_003)
    v[-1_000:] = float("inf")
    compare("ragged 1,000,003, 14 edges, per-particle sigma", v, hist_edges,
            sig, hcot)
    compare("ragged 1,000,003, 11 edges, scalar sigma", 9.5 + 0.1 * v,
            smf_edges, torch.tensor(0.2, device=dev), cot)
    hist = hist_inputs(1_000_000)
    smf = (make_smf_data(100_000_000)["log_halo_masses"] - 1.0).contiguous()
    shapes = (
        ("SMF 1e8 halos, 11 edges, scalar sigma", smf, smf_edges,
         torch.tensor(0.5, device=dev), cot, 20, 10),
        ("history chunk 1e6 halos, 14 edges, per-particle sigma", hist[0],
         hist_edges, hist[1], hcot, 50, 50))
    for label, v, e, s, g, reps, calls in shapes:
        compare(label, v, e, s, g)
        runs = {"old forward": lambda: old_fwd(v, e, s),
                "new forward": lambda: new_fwd(v, e, s),
                "old backward": lambda: old_bwd(v, e, s, g),
                "new backward": lambda: new_bwd(v, e, s, g)}
        wall = {k: [] for k in runs}
        device = {k: [] for k in runs}
        for order in (("old", "new"), ("new", "old")):
            for side in order:
                for name, fn in runs.items():
                    if name.startswith(side):
                        wall[name].append(time_ms(fn, reps))
                        device[name].append(device_ms(fn, calls))
        for name in runs:
            print(f"{label}: {name}: ms with the wrapper (turns) "
                  f"{[round(t, 4) for t in wall[name]]}; device ms a call, "
                  f"all kernels / the erf kernel (turns) {device[name]}",
                  flush=True)

        lib = ek._lib()
        n, n_edges = v.shape[0], e.shape[0]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        vec = int(s.dim() > 0)
        s_k = s if vec else s.reshape(1)
        groups = -(-n // (ek.PER_THREAD * cuda_build._THREADS))
        # A block per PER_BLOCK particles, not rounded to a multiple of
        # the SMs, beside the others.
        grids = sorted({min(b * sms, groups) for b in (1, 2, 3, 4, 8, 16)}
                       | {groups, ek.erf_grid(n, sms),
                          min(-(-n // cuda_build.PER_BLOCK), 16 * sms)})
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
        part = torch.empty(max(grids) * (n_edges + 1), device=dev)
        counts = torch.empty(n_edges - 1, device=dev)
        dv, de = torch.empty_like(v), torch.empty_like(e)
        ds = torch.empty_like(v) if vec else torch.empty((), device=dev)
        sweep = []
        for grid in grids:
            def fwd():
                lib.erf_counts_fwd(v.data_ptr(), n, e.data_ptr(), n_edges,
                                   s_k.data_ptr(), vec, part.data_ptr(),
                                   counters.data_ptr(), grid,
                                   counts.data_ptr(), stream())

            def bwd():
                lib.erf_counts_bwd(v.data_ptr(), n, e.data_ptr(), n_edges,
                                   s_k.data_ptr(), vec, g.data_ptr(),
                                   dv.data_ptr(), de.data_ptr(),
                                   ds.data_ptr(), part.data_ptr(),
                                   counters.data_ptr() + 4, grid, stream())
            sweep.append((grid, device_ms(fwd, calls)[1],
                          device_ms(bwd, calls)[1]))
        print(f"{label}: grid sweep, new kernels' device ms a launch "
              f"(blocks, forward, backward; erf_grid picks "
              f"{ek.erf_grid(n, sms)}): {sweep}", flush=True)
        del v, s
    if failed:
        print(f"erf_kernels_ab: FAILED {failed}", flush=True)
        return 1
    print("erf_kernels_ab: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
