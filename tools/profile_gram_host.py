#!/usr/bin/env python3
"""Host time of the cross-Gram wrapper, line by line, on one NVIDIA GPU.

    python3 tools/profile_gram_host.py [ROOT ...]

For each checkout ROOT (by default the one this file is in), in its own
process: the host time of one ``gram_cuda`` call of ROOT's package at the
serving shape (10000 x 2048) and the SVGP shape (256 x 256), then each
statement the wrapper is made of, alone (the statements of the wrapper
before and after its host work was cut, named apart). Every figure is the
mean of ``CALLS`` calls timed by ``time.perf_counter`` while a spin kernel
holds the stream, so no call waits for the device: it is the host's work
alone, the part of a call's time that no kernel design removes. The card's
name and power limit come first. Needs a CUDA device.
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

CALLS = 200  # queued launches stay far below the launch queue's depth
SPIN = 400_000_000  # ~0.2 s at the H100's clock: longer than CALLS calls of any statement


def host_us(fn, calls=CALLS):
    """Mean microseconds of host time a call of fn, queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        torch.cuda._sleep(SPIN)
        done = torch.cuda.Event()
        done.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        late = done.query()  # the spin ended early: the calls may have waited on the device
        torch.cuda.synchronize()
        if late:
            raise RuntimeError("the spin ended before the timed calls were queued; raise SPIN")
        samples.append((t1 - t0) / calls * 1e6)
    return sorted(samples)[len(samples) // 2]


def measure(root):
    sys.path.insert(0, root)
    from gpflow_slim_tpu_torch.ops import _build, gram

    tag = os.path.basename(root)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    var = torch.tensor(1.0, device=dev)
    lib = _build.load_library()
    for n, m in ((10000, 2048), (256, 256)):
        Xs = torch.rand(n, 1, generator=g, device=dev) / 0.1
        X2s = torch.rand(m, 1, generator=g, device=dev) / 0.1
        out = torch.empty(n, m, device=dev)
        idx = Xs.get_device()
        stream = torch.cuda.current_stream(dev).cuda_stream
        by_shape = {}

        def launch():
            return lib.gfs_gram(Xs.data_ptr(), n, X2s.data_ptr(), m, 1, var.data_ptr(), 0, out.data_ptr(), stream)

        def count():
            by_shape[n, m] = by_shape.get((n, m), 0) + 1

        def check_xs():
            for x in (Xs, X2s):
                if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2:
                    raise ValueError
                if not x.is_contiguous():
                    raise ValueError
                if x.shape[1] < 1:
                    raise ValueError

        steps = {
            f"gram_cuda, the whole call of {tag}": lambda: gram.gram_cuda("rbf", Xs, X2s, var),
            "the checks of the inputs (_check_xs)": check_xs,
            "before: X2s.device != Xs.device": lambda: X2s.device != Xs.device,
            "after: X2s.get_device() != Xs.get_device()": lambda: X2s.get_device() != Xs.get_device(),
            "before: torch.as_tensor(var, float32, device).reshape(1)":
                lambda: torch.as_tensor(var, dtype=torch.float32, device=Xs.device).reshape(1),
            "after: the variance tensor's own address (dtype, numel, device checked)":
                lambda: var.dtype == torch.float32 and var.numel() == 1 and var.get_device() == idx,
            "before: torch.empty((N, M), dtype, device)":
                lambda: torch.empty((n, m), dtype=torch.float32, device=Xs.device),
            "after: Xs.new_empty((N, M))": lambda: Xs.new_empty((n, m)),
            "before: torch.cuda.current_stream(device).cuda_stream":
                lambda: torch.cuda.current_stream(Xs.device).cuda_stream,
            "after: torch._C._cuda_getCurrentRawStream(index)":
                lambda: torch._C._cuda_getCurrentRawStream(idx),
            "_build.load_library() (cached)": _build.load_library,
            "the ctypes call that launches the kernel": launch,
            "the launch counters": count,
            "the ctypes call's arguments alone (data_ptr x 4)":
                lambda: (Xs.data_ptr(), X2s.data_ptr(), var.data_ptr(), out.data_ptr()),
            "a ctypes call of an entry with no work (gfs_error_string)": lambda: lib.gfs_error_string(0),
        }
        for what, fn in steps.items():
            print(f"{tag} {n} x {m}: {what}: {host_us(fn):.2f} us", flush=True)


def main():
    if not torch.cuda.is_available():
        print("profile_gram_host: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    roots = [os.path.abspath(r) for r in sys.argv[1:]] or [REPO]
    if len(roots) > 1:  # one process a checkout: each imports its own package
        print(cs.card_line(), flush=True)
        for r in roots:
            subprocess.run([sys.executable, os.path.abspath(__file__), r], check=True)
        return 0
    if len(sys.argv) < 2:
        print(cs.card_line(), flush=True)
    measure(roots[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
