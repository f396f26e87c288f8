#!/usr/bin/env python3
"""Diagnoses of the Cholesky kernels' split trailing update on one NVIDIA GPU.

    python3 tools/split_diag.py [--variants] [--plain] [--only NAME,...]

``--variants`` copies this checkout's ``gpflow_slim_tpu_torch``, ``tools``
and ``chip_smoke.py`` into ``build/variants/<name>/`` (gitignored), edits
each copy's CUDA sources, builds them all at once (one process each, each
building its own ``build/kernels``), and prints for each the trailing
kernels' registers and spills (ptxas) and the trailing update's rates by
arithmetic (``tools/profile_torch_gpr.py --chol`` run in the copy); for the
variants that sum the split's products otherwise, and ``shipped``, also the
split modes' half-logdet error on fault l's grid
(``tools/chol_logdet_diag.py`` run in the copy). ``--only`` names the
variants to run (all by default):

- ``shipped``: the sources as they are;
- ``two_blocks``: the split kernels at two blocks an SM
  (``__launch_bounds__(256, 2)``, as the exact kernel), which spills;
- ``no_lo``: the lo halves not computed (lo = hi), the split's products
  without the cost of forming them (its results are wrong: timing only);
- ``chained``: hh and the small passes each accumulated inside the tensor
  core across the MMA steps of 64 inner indices (the shipped kernel
  computes each step from zero and adds it in f32, rounded to nearest);
- ``one_accumulator``: every pass accumulated inside the tensor core into
  one accumulator.

``--plain`` prints the half-logdet of bench.py's operand (RBF lengthscale
0.1, noise 1) at N = 2000 and 10000 against the float64 factor of the same
float32 input: the kernel in "s3" and "s4", and its plain split version in
float64 and in float32 with each panel's product applied 64 inner indices
at a time (as the kernel adds them to its tile) and 256 (the TPU kernel's
one update a panel).

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import re
import shutil
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

SPLIT_BOUNDS = "__launch_bounds__(gfs::kMmThreads, 1)"
LO = ("  lo = bf16_pair(__float2bfloat16_rn(x0 - __bfloat162float(h0)), "
      "__float2bfloat16_rn(x1 - __bfloat162float(h1)));")
STEP = "        float t[4] = {}, u[4] = {};\n"
ADD_STEP = ("          hh[mt][nt][i] += t[i];\n", "          x[mt][nt][i] += u[i];\n")


def chained_into(small):
    """Edits that make each MMA step accumulate into hh, and the small
    passes into ``small``, inside the tensor core."""
    return [("chol_solve.cu", STEP, f"        float(&t)[4] = hh[mt][nt];\n        float(&u)[4] = {small}[mt][nt];\n")] + [
        ("chol_solve.cu", add, "") for add in ADD_STEP]


# name -> [(source file under csrc/, text, replacement), ...]
EDITS = {
    "shipped": [],
    "two_blocks": [("chol_solve.cu", SPLIT_BOUNDS, "__launch_bounds__(gfs::kMmThreads, 2)")],
    "no_lo": [("common.cuh", LO, "  lo = hi;")],
    "chained": chained_into("x"),
    "one_accumulator": chained_into("hh"),
}
LOGDET = ("shipped", "chained", "one_accumulator")  # the variants whose half-logdet error is printed
BUILD = ("from gpflow_slim_tpu_torch.ops import _build\n"
         "so = _build.build()\n"
         "print(so.with_suffix('.log').read_text())\n")


def variants(names):
    """Build each variant in its copy, then time each one's trailing update
    (and read the split's half-logdet error where the summation differs)."""
    procs = {}
    for name in names:
        root = os.path.join(REPO, "build", "variants", name)
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        for item in ("gpflow_slim_tpu_torch", "tools"):
            shutil.copytree(os.path.join(REPO, item), os.path.join(root, item),
                            ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        for source, old, new in EDITS[name]:
            path = os.path.join(root, "gpflow_slim_tpu_torch", "csrc", source)
            text = open(path).read()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to edit is not once in {source}: {old!r}")
            open(path, "w").write(text.replace(old, new))
        procs[name] = (root, subprocess.Popen([sys.executable, "-c", BUILD], cwd=root, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    for name, (root, proc) in procs.items():
        log = proc.communicate()[0].splitlines()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n" + "\n".join(log[-40:]))
        for i, line in enumerate(log):
            m = re.search(r"chol_trailing_kernelILi(\d)E", line)
            if m and "Compiling entry" in line:
                print(f"{name} chol_trailing_kernel<{m[1]}>: {log[i + 2].strip()}; {log[i + 3].strip()}")
    for name, (root, _) in procs.items():
        runs = [("profile_torch_gpr.py", "--chol")] + ([("chol_logdet_diag.py",)] if name in LOGDET else [])
        for run in runs:
            out = subprocess.run([sys.executable, os.path.join("tools", *run[:1]), *run[1:]], cwd=root,
                                 capture_output=True, text=True, check=True).stdout
            for line in out.splitlines():
                if line.startswith(("trailing update", "jitter", "  syrk=")):
                    print(f"{name}: {line}", flush=True)


def plain():
    """The half-logdet of the kernel and its plain split versions against f64."""
    from gpflow_slim_tpu_torch.ops import cholesky, gram

    dev = torch.device("cuda")
    X, Y = cs.bench_data()
    one = torch.tensor(1.0, device=dev)
    for n in (2000, 10000):
        Np = n + (-n) % cholesky.BLOCK
        Kp = gram.gram_chol_operand_cuda("rbf", (torch.tensor(X[:n], device=dev) / cs.LENGTHSCALE).contiguous(),
                                         one, one, Np)
        D = torch.zeros(Np, 1, device=dev)
        D[:n] = torch.tensor(Y[:n], device=dev)
        K64 = torch.tril(Kp).double()
        ref = float(cholesky.cholesky_solve_plain(K64.clone(), D.double())[2])
        got = {}
        for syrk in ("s3", "s4"):
            got[f"{syrk} kernel"] = float(cholesky.cholesky_solve_cuda(Kp.clone(), D, syrk)[2])
            for chunk in (64, 256):
                got[f"{syrk} plain f64 chunk {chunk}"] = float(
                    cholesky.cholesky_solve_split_plain(K64.clone(), D.double(), syrk, chunk=chunk)[2])
                got[f"{syrk} plain f32 chunk {chunk}"] = float(
                    cholesky.cholesky_solve_split_plain(torch.tril(Kp), D, syrk, chunk=chunk)[2])
        print(f"N={n} (Np={Np}) half_logdet f64 {ref:.6f}, relative error: "
              + ", ".join(f"{k} {(v - ref) / abs(ref):+.2e}" for k, v in got.items()), flush=True)


def main():
    if not torch.cuda.is_available():
        print("split_diag: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(cs.card_line())
    if "--plain" in sys.argv or "--variants" not in sys.argv:
        plain()
    if "--variants" in sys.argv or "--plain" not in sys.argv:
        names = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else list(EDITS)
        variants(names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
