#!/usr/bin/env python3
"""Where the history model's card-versus-CPU gap comes from.

    python3 tools/hist_card_vs_cpu.py

Needs one NVIDIA GPU.  For each catalog size, 2e5 and 1e6 halos (in
chunks of a quarter of it, as ``chip_smoke.py``'s phase 9 takes at 1e6
halos), each seed 0, 1, 2 (seed 0 is TRUTH + 0.05, phase 9's point; seed
s > 0 adds 0.01·N(0, 1) from ``numpy.random.default_rng(s)``) and each
configuration

- ``dense``: ``make_galhalo_hist_data``'s defaults (14 edges, epochs 7,
  12, 15);
- ``dense41``: the dense path at the fused configuration (41 edges on
  [7, 11.75], epochs 5, 7, ..., 15), the control for ``fused``;
- ``fused``: the same with ``bin_mode="fused"`` and a 33-edge window;

the sumstats, loss and gradient of the model on the card (the CUDA
kernels) are held against

- ``cpu``: the same data on the CPU (the plain versions), as phase 9 does;
- ``fed``: the CPU model fed the card's mean log M* and so the same
  kernel inputs: only the counts (kernels against plain versions), the
  scatter and the loss differ, not PyTorch's transcendental functions.

Each gap is printed as the rtol that ``allclose`` would need (with atol
1e-10 for the sumstats and 1e-7 for the gradient) and the loss's relative
difference.  The whole is run once for each form of the erf polynomial's
Horner step in ``csrc/erf_common.cuh`` (``rn``: a separately rounded
multiply and add, as PyTorch's CPU ops round them; ``fma``: ``acc * x2 +
c``, which nvcc contracts into a fused multiply-add), each from a copy of
the sources under ``build/hist_card_vs_cpu/<form>/``, in its own process.
The rows go to ``chiprun_out/hist_card_vs_cpu.json``.
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "chiprun_out", "hist_card_vs_cpu.json")
FORMS = {"rn": "__fadd_rn(__fmul_rn(acc, x2), c)", "fma": "acc * x2 + c"}
HORNER = re.compile(r"(float horner\(float acc, float x2, float c\) \{\s*"
                    r"return )[^;]*;")
FUSED_EDGES = (7.0, 11.75, 41)
FUSED_OBS = (5, 7, 9, 11, 13, 15)
HALOS = (200_000, 1_000_000)
SEEDS = (0, 1, 2)


def configs(np):
    wide = dict(bin_edges=np.linspace(*FUSED_EDGES), obs_indices=FUSED_OBS)
    return (("dense", {}), ("dense41", wide),
            ("fused", dict(wide, bin_mode="fused", sigma_max=0.32)))


def use_form(form):
    """Point the kernel build at a copy of ``csrc/`` whose Horner step has
    the given form."""
    from multigrad_tpu_torch.ops import cuda_build
    root = os.path.join(HERE, "build", "hist_card_vs_cpu", form)
    csrc = os.path.join(root, "csrc")
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, csrc)
    header = os.path.join(csrc, "erf_common.cuh")
    text, hits = HORNER.subn(lambda m: m.group(1) + FORMS[form] + ";",
                             open(header).read())
    if hits != 1:
        raise RuntimeError(f"no single horner() in {header}")
    with open(header, "w") as f:
        f.write(text)
    cuda_build.CSRC = type(cuda_build.CSRC)(csrc)
    cuda_build.set_build_dir(os.path.join(root, "lib"))


def gaps(card, ref):
    """How far ``card`` is from ``ref`` (each ``(sumstats, loss, grad)``,
    as :func:`evaluate` gives them): the rtol that ``allclose`` needs for
    the sumstats (atol 1e-10) and the gradient (atol 1e-7), and the
    loss's relative difference."""
    import numpy as np

    def rtol(a, b, atol):
        excess = np.maximum(np.abs(a - b) - atol, 0.0)
        return float(np.max(excess / np.maximum(np.abs(b), 1e-300)))
    return dict(y_rtol=rtol(card[0], ref[0], 1e-10),
                loss_rel=abs(card[1] - ref[1]) / abs(ref[1]),
                grad_rtol=rtol(card[2], ref[2], 1e-7))


def evaluate(model, params):
    """``(sumstats, loss, grad)`` of ``model`` at ``params``, as float64
    numpy."""
    y = model.calc_sumstats_from_params(params)
    loss, grad = model.calc_loss_and_grad_from_params(params)
    return (y.detach().cpu().double().numpy(), float(loss),
            grad.detach().cpu().double().numpy())


def evaluate_fed(cpu, aux, params):
    """:func:`evaluate` of the CPU history model ``cpu`` with the mean
    log M* that the data ``aux`` (on the card, same chunks) gives fed into
    its forward; its gradient still flows through the CPU's history."""
    import torch
    from multigrad_tpu_torch.models import galhalo_hist as gh
    fed = {}
    with torch.no_grad():
        for chunk in gh._halo_chunks(aux["log_halo_masses"],
                                     aux["chunk_size"]):
            key = (chunk.shape[0], float(chunk[0]), float(chunk[-1]))
            fed[key] = gh._mean_log_mstar_block(
                chunk, torch.as_tensor(params, device=chunk.device),
                aux["time_grid"], aux["obs_indices"]).cpu()
    block = gh._mean_log_mstar_block

    def fed_block(lm, p, t_grid, obs):
        out = block(lm, p, t_grid, obs)
        key = (lm.shape[0], float(lm[0]), float(lm[-1]))
        return out + (fed[key] - out).detach()
    gh._mean_log_mstar_block = fed_block
    try:
        return evaluate(cpu, params)
    finally:
        gh._mean_log_mstar_block = block


def measure(form):
    """The rows of one form of the polynomial, already built."""
    import numpy as np
    import torch
    from multigrad_tpu_torch.models import (GalhaloHistModel,
                                            make_galhalo_hist_data)
    from multigrad_tpu_torch.models import galhalo_hist as gh

    rows = []
    for n in HALOS:
        for name, kwargs in configs(np):
            aux = make_galhalo_hist_data(n, chunk_size=n // 4, **kwargs)
            gpu = GalhaloHistModel(aux_data=aux)
            cpu = GalhaloHistModel(aux_data={
                k: (x.cpu() if isinstance(x, torch.Tensor) else x)
                for k, x in aux.items()})
            for seed in SEEDS:
                params = np.array(gh.TRUTH, np.float64) + 0.05
                if seed:
                    params += 0.01 * np.random.default_rng(seed) \
                        .standard_normal(params.shape[0])
                params = params.astype(np.float32)
                t0 = time.perf_counter()
                card = evaluate(gpu, params)
                row = dict(form=form, halos=n, config=name, seed=seed,
                           loss=card[1])
                for ref_name, ref in (("cpu", evaluate(cpu, params)),
                                      ("fed", evaluate_fed(cpu, aux,
                                                           params))):
                    row[ref_name] = gaps(card, ref)
                row["seconds"] = time.perf_counter() - t0
                print(json.dumps(row), flush=True)
                rows.append(row)
            del gpu, cpu, aux
    return rows


def run_form(form):
    use_form(form)
    from multigrad_tpu_torch.ops import cuda_build
    cuda_build.build()
    return measure(form)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--form", help=argparse.SUPPRESS)  # one form, in-process
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("hist_card_vs_cpu: no CUDA device is available",
              file=sys.stderr)
        return 1
    if args.form:
        run_form(args.form)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    rows = []
    for form in FORMS:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--form", form],
            check=True, capture_output=True, text=True).stdout
        sys.stdout.write(out)
        rows += [json.loads(line) for line in out.splitlines()
                 if line.startswith("{")]
    print("worst over seeds: form halos config | card vs cpu: y_rtol "
          "loss_rel grad_rtol | card vs fed: y_rtol loss_rel grad_rtol")
    keys = sorted({(r["form"], r["halos"], r["config"]) for r in rows})
    for key in keys:
        sel = [r for r in rows if (r["form"], r["halos"], r["config"]) == key]
        cells = [max(r[ref][m] for r in sel) for ref in ("cpu", "fed")
                 for m in ("y_rtol", "loss_rel", "grad_rtol")]
        print(" ".join(str(k) for k in key) + " | "
              + " ".join(f"{c:.3e}" for c in cells[:3]) + " | "
              + " ".join(f"{c:.3e}" for c in cells[3:]))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(dict(card=smi, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
