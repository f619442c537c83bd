#!/usr/bin/env python3
"""The one-launch fused erf-CDF kernels against the masses kernels they
replace, against another build of themselves, and over their grid, on one
card.

    python3 tools/fused_kernels_ab.py [--old OLD_FUSED_MASSES_CU]
                                      [--variant FUSED_COUNTS_CU ...]

``--old``: ``csrc/fused_masses.cu`` as it was before the window start,
the scatter into bins and the backward's gather moved into the kernels
(its C interface: ``fused_masses_fwd`` writing the ``(W-1, N)`` masses,
``fused_masses_bwd`` taking their cotangent), for example ``git show
6d71026:multigrad_tpu_torch/csrc/fused_masses.cu``.  It is driven as its
wrappers drove it: the old forward is ``window_starts`` (a searchsorted),
the masses kernel and ``scatter_bin_masses`` (an ``index_add`` and a
diagonal sum); the old backward is autograd through that scatter (the
gathers of the counts' cotangent into the window's ``(W-1, N)``), the
masses' backward kernel and, for a scalar sigma, ``sum_rows_kernel`` and
the host-side scaling.  The new ones are ``fused_counts_fwd_cuda`` and
``fused_counts_bwd_cuda``, one launch each.  At a history chunk's launch
shape (1e6 halos, 41 edges, W = 33, a per-particle sigma) and at 1e8 halos
with a scalar sigma it reports how far the new counts and gradients lie
from the old path's (max|err| over max|count| or max|grad|), checks them
within the plain versions' limits (counts 2e-5, gradients rtol 1e-3 with
atol 1e-5·max|grad|), and times old and new in turns (old, new, new,
old).

``--variant`` (repeatable): another ``fused_counts.cu`` with the repo's C
interface (an experiment on the kernels), launched on the same grid as
the repo's (``fused_grid``).  At 1e6 (per-particle sigma) and 1e8 (per-particle and
scalar sigma) it checks that both give the same outputs bit for bit, and
times them in turns (repo, variant, variant, repo), forward and backward
without dedges (the history path's launches).

Always: the repo's kernels' device time per launch over grids of 1 to 16
blocks an SM and one block per 1,024, 2,048 or 4,096 particles, at 1e6
and 1e8 halos (per-particle sigma), against the grid ``fused_grid``
picks; then their device time per launch at 1e6, 4e6, 1.6e7 and 1e8
halos, which separates a launch's fixed cost from its cost per particle.

Times are the median of CUDA-event runs (ms a call, with the wrapper or
the bare ctypes call) and the device time per call (every kernel of the
call) from the torch profiler.  Each source is built with the package's
``nvcc`` flags beside ``csrc/erf_common.cuh`` under
``build/fused_kernels_ab/``, all at once.  Needs one NVIDIA GPU.  Prints
one line per check and per time; exits non-zero if a check fails.
"""
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = (7.0, 11.75, 41)
WINDOW = 33


def start_build(source, name):
    """Start nvcc on a copy of ``source`` under build/fused_kernels_ab/;
    return (process, library path)."""
    from multigrad_tpu_torch.ops import cuda_build
    out = os.path.join(HERE, "build", "fused_kernels_ab")
    os.makedirs(out, exist_ok=True)
    shutil.copy(source, os.path.join(out, f"{name}.cu"))
    shutil.copy(cuda_build.CSRC / "erf_common.cuh", out)
    lib_path = os.path.join(out, f"lib{name}.so")
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                             "-o", lib_path, os.path.join(out, f"{name}.cu")])
    return proc, lib_path


def load_old(proc, lib_path):
    """The old masses library, with its own C interface."""
    if proc.wait() != 0:
        raise RuntimeError("nvcc failed on the old source")
    lib = ctypes.CDLL(lib_path)
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.fused_masses_fwd.argtypes = [p, i64, p, i32, p, i32, p, i32, p, i32,
                                     p]
    lib.fused_masses_bwd.argtypes = [p, i64, p, i32, p, i32, p, i32, p, p, p,
                                     p, p, i32, p, p]
    lib.fused_masses_fwd.restype = lib.fused_masses_bwd.restype = ctypes.c_int
    return lib


def load_variant(proc, lib_path):
    """A library with the repo's fused C interface."""
    from multigrad_tpu_torch.ops import fused_kernels as fk
    if proc.wait() != 0:
        raise RuntimeError("nvcc failed on the variant source")
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in fk._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def parent_grid(n, sms):
    """The old masses kernels' grid: one block per 256 particles, at most
    8 an SM."""
    return max(1, min(-(-n // 256), sms * 8))


def device_ms(fn, calls):
    """Device ms per call of ``fn``, every kernel it launches, from a torch
    profiler window of ``calls`` calls; None where the profiler saw no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(evt.time_range.elapsed_us() for evt in prof.events()
                if evt.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls / 1e3 if total else None


def time_ms(fn, reps):
    import torch
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


def main(argv):
    import argparse

    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--old", help="the parent's fused_masses.cu")
    parser.add_argument("--variant", action="append", default=[],
                        help="another fused_counts.cu (repeatable)")
    args = parser.parse_args(argv[1:])
    if not torch.cuda.is_available():
        print("fused_kernels_ab: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from multigrad_tpu_torch.ops import binned as tb
    from multigrad_tpu_torch.ops import cuda_build
    from multigrad_tpu_torch.ops import fused_kernels as fk
    from multigrad_tpu_torch.ops.erf_kernels import (_INV_SQRT_PI, _SQRT2,
                                                     PAD_VALUE, _inv)

    dev = torch.device("cuda", torch.cuda.current_device())
    builds = {name: start_build(path, name) for name, path in (
        [("fused_masses_old", args.old)] + [
            (f"fused_counts_variant{k}", path)
            for k, path in enumerate(args.variant)]) if path}
    cuda_build.build((fk.SOURCE,))
    old = load_old(*builds["fused_masses_old"]) if args.old else None
    variants = [(path, load_variant(*builds[f"fused_counts_variant{k}"]))
                for k, path in enumerate(args.variant)]
    repo = cuda_build.load(fk.SOURCE, fk._SIGNATURES)
    failed = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = cuda_build.workspace(dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def launcher(lib, v, e, s, dcounts, grid=None):
        """(forward, backward without dedges) by ``lib``'s C functions on
        ``grid`` blocks (``fused_grid``'s by default), outputs allocated
        once."""
        n, n_edges = v.shape[0], e.shape[0]
        grid = grid or fk.fused_grid(n, sms, n_edges)
        counts = torch.empty(n_edges - 1, device=dev)
        dv, ds = torch.empty_like(v), torch.empty_like(s)

        def fwd():
            cuda_build.raise_on(lib.fused_counts_fwd(
                v.data_ptr(), n, e.data_ptr(), n_edges, s.data_ptr(),
                s.dim(), WINDOW, ws.partials, cuda_build.PARTIALS,
                ws.counter(cuda_build.FUSED_FWD), grid, counts.data_ptr(),
                ws.stream), "fused_counts_fwd")
            return counts

        def bwd():
            cuda_build.raise_on(lib.fused_counts_bwd(
                v.data_ptr(), n, e.data_ptr(), n_edges, s.data_ptr(),
                s.dim(), WINDOW, dcounts.data_ptr(), dv.data_ptr(), None,
                ds.data_ptr(), ws.partials, cuda_build.PARTIALS,
                ws.counter(cuda_build.FUSED_BWD), grid, ws.stream),
                "fused_counts_bwd")
            return dv, ds

        return fwd, bwd

    def in_turns(label, runs, first, second, reps, calls):
        """Time ``runs`` ({"<side> forward": fn, ...}) in turns: first,
        second, second, first."""
        wall = {k: [] for k in runs}
        device = {k: [] for k in runs}
        for order in ((first, second), (second, first)):
            for side in order:
                for name, fn in runs.items():
                    if name.startswith(side):
                        wall[name].append(time_ms(fn, reps))
                        device[name].append(device_ms(fn, calls))
        for name in runs:
            print(f"{label}: {name}: ms a call (turns) "
                  f"{[round(t, 4) for t in wall[name]]}; device ms a call, "
                  f"all kernels (turns) {device[name]}", flush=True)

    class OldPath:
        """The parent's composition around its masses kernels, with the
        forward's window starts kept for the backward, as its autograd
        graph kept them."""

        def __init__(self, v, e, s, dcounts):
            self.v, self.e, self.s, self.dcounts = v, e, s, dcounts
            self.vec = int(s.dim() > 0)
            self.grid = parent_grid(v.shape[0], sms)
            counts, self.start, masses = self.forward(keep=True)
            leaf = masses.requires_grad_()
            self.leaf = leaf
            self.graph = tb.scatter_bin_masses(leaf.t(), self.start,
                                               e.shape[0])

        def forward(self, keep=False):
            v, e, s = self.v, self.e, self.s
            n = v.shape[0]
            start = tb.window_starts(torch.clamp(v, -PAD_VALUE, PAD_VALUE),
                                     e, s, WINDOW)
            masses = torch.empty((WINDOW - 1, n), device=dev)
            code = old.fused_masses_fwd(
                v.data_ptr(), n, e.data_ptr(), e.shape[0], s.data_ptr(),
                self.vec, start.data_ptr(), WINDOW, masses.data_ptr(),
                self.grid, stream())
            cuda_build.raise_on(code, "old fused_masses_fwd")
            counts = tb.scatter_bin_masses(masses.t(), start, e.shape[0])
            return (counts, start, masses) if keep else counts

        def backward(self):
            v, e, s = self.v, self.e, self.s
            n = v.shape[0]
            (g,) = torch.autograd.grad(self.graph, self.leaf, self.dcounts,
                                       retain_graph=True)
            g = g.contiguous()
            dv = torch.empty_like(v)
            ds = torch.empty_like(v) if self.vec else None
            partials = None if self.vec else torch.empty(self.grid,
                                                         device=dev)
            ds_sum = None if self.vec else torch.empty(1, device=dev)
            code = old.fused_masses_bwd(
                v.data_ptr(), n, e.data_ptr(), e.shape[0], s.data_ptr(),
                self.vec, self.start.data_ptr(), WINDOW, g.data_ptr(),
                dv.data_ptr(), None, None if ds is None else ds.data_ptr(),
                None if partials is None else partials.data_ptr(), self.grid,
                None if ds_sum is None else ds_sum.data_ptr(), stream())
            cuda_build.raise_on(code, "old fused_masses_bwd")
            if not self.vec:
                ds = -(ds_sum[0] * _inv(s) * (_SQRT2 * _INV_SQRT_PI))
            return dv, ds

    gen = torch.Generator(device=dev).manual_seed(7)
    edges = torch.linspace(*EDGES, device=dev)
    dcounts = torch.randn(EDGES[2] - 1, generator=gen, device=dev)
    v6 = 9.4 + 0.9 * torch.randn(1_000_000, generator=gen, device=dev)
    s6 = 0.08 + 0.24 * torch.rand(1_000_000, generator=gen, device=dev)
    v8 = 9.4 + 0.9 * torch.randn(100_000_000, generator=gen, device=dev)
    s8 = 0.08 + 0.24 * torch.rand(100_000_000, generator=gen, device=dev)
    scalar = torch.tensor(0.25, device=dev)
    chunk = ("history chunk 1e6 halos, 41 edges, W=33, per-particle sigma",
             v6, s6, 50, 50)
    big_vec = ("1e8 halos, 41 edges, W=33, per-particle sigma", v8, s8, 10,
               5)
    big_scalar = ("1e8 halos, 41 edges, W=33, scalar sigma", v8, scalar, 10,
                  5)
    if old is not None:
        for label, v, s, reps, calls in (chunk, big_scalar):
            path = OldPath(v, edges, s, dcounts)
            want = path.forward()
            got = fk.fused_counts_fwd_cuda(v, edges, s, WINDOW)
            scale = float(want.abs().max())
            fwd_err = float((got - want).abs().max()) / scale
            if fwd_err > 2e-5:
                failed.append(f"{label}: counts")
            errs = []
            new_grads = fk.fused_counts_bwd_cuda(v, edges, s, WINDOW,
                                                 dcounts)
            for name, a, b in zip(("dvalues", "dsigma"),
                                  (new_grads[0], new_grads[2]),
                                  path.backward()):
                gscale = float(b.abs().max())
                if float(((a - b).abs() - 1e-3 * b.abs()).max()) \
                        > 1e-5 * gscale:
                    failed.append(f"{label}: {name}")
                errs.append(float((a - b).abs().max()) / gscale)
            print(f"{label}: counts against the old path max|err|/max|count| "
                  f"{fwd_err:.3e} (counts up to {scale:.6g}); gradients "
                  f"max|err|/max|grad| dvalues {errs[0]:.3e}, dsigma "
                  f"{errs[1]:.3e}", flush=True)
            del want, got, new_grads
            in_turns(f"{label}, with the wrappers", {
                "old forward": path.forward,
                "new forward": lambda: fk.fused_counts_fwd_cuda(
                    v, edges, s, WINDOW),
                "old backward": path.backward,
                "new backward": lambda: fk.fused_counts_bwd_cuda(
                    v, edges, s, WINDOW, dcounts)}, "old", "new", reps,
                calls)
            del path
            torch.cuda.empty_cache()
    for path, variant in variants:
        print(f"variant {path}", flush=True)
        for label, v, s, reps, calls in (chunk, big_vec, big_scalar):
            r_fwd, r_bwd = launcher(repo, v, edges, s, dcounts)
            x_fwd, x_bwd = launcher(variant, v, edges, s, dcounts)
            same = (torch.equal(r_fwd().clone(), x_fwd())
                    and all(torch.equal(a.clone(), b)
                            for a, b in zip(r_bwd(), x_bwd())))
            if not same:
                failed.append(f"{label}: the variant's outputs differ")
            print(f"{label}: the variant's counts, dvalues and dsigma "
                  f"{'equal' if same else 'DIFFER from'} the repo's bit for "
                  "bit", flush=True)
            in_turns(f"{label}, the bare C call", {
                "repo forward": r_fwd, "variant forward": x_fwd,
                "repo backward": r_bwd, "variant backward": x_bwd},
                "repo", "variant", reps, calls)
    for label, v, s, _, _ in (chunk, big_vec):
        n = v.shape[0]
        grids = sorted({b * sms for b in (1, 2, 3, 4, 6, 8, 12, 16)}
                       | {min(-(-n // k), 16 * sms)
                          for k in (1024, 2048, 4096)}
                       | {fk.fused_grid(n, sms, EDGES[2])})
        calls = 20 if n < 100_000_000 else 5
        sweep = []
        for grid in grids:
            fwd, bwd = launcher(repo, v, edges, s, dcounts, grid)
            sweep.append((grid, device_ms(fwd, calls),
                          device_ms(bwd, calls)))
        print(f"{label}: grid sweep, device ms a launch (blocks, forward, "
              f"backward; fused_grid picks {fk.fused_grid(n, sms, EDGES[2])})"
              f": {sweep}", flush=True)
    sweep = []
    for n in (1_000_000, 4_000_000, 16_000_000, 100_000_000):
        v, s = v8[:n], s8[:n]
        calls = 20 if n < 100_000_000 else 5
        sweep.append((n, device_ms(lambda: fk.fused_counts_fwd_cuda(
            v, edges, s, WINDOW), calls), device_ms(
            lambda: fk.fused_counts_bwd_cuda(v, edges, s, WINDOW, dcounts),
            calls)))
    print("size sweep, per-particle sigma, new kernels' device ms a launch "
          f"(halos, forward, backward): {sweep}", flush=True)
    if failed:
        print(f"fused_kernels_ab: FAILED {failed}", flush=True)
        return 1
    print("fused_kernels_ab: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
