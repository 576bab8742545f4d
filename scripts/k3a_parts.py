#!/usr/bin/env python3
"""Where K3a's time goes, on one NVIDIA GPU: the LSTM forward recurrence
kernel (`bcnf_tpu_torch/ops/csrc/lstm_kernel.cu`, `lstm_fwd_kernel`) timed
as built and with one part of its step taken out.

Run from the root of a checkout on a machine with a card:

    python3 scripts/k3a_parts.py [OTHER_LSTM_KERNEL.cu ...]

Each variant is the source's text with a patch inside the forward kernel
(`no_exchange`: the distributed-shared-memory push of the new h is not
stored; `no_product`: the step's gate product is skipped), compiled by nvcc
for the flagship's and t_DLSTM_large's per-gate widths only (TN 5 and 4).
Extra source files given on the command line (other designs of the same
kernel, with the same C entry point `bcnf_lstm_fwd` taking W_hh (H, 4H) as it
is) are timed as built beside it. A variant
with a part taken out computes wrong values; only the time is read. Times:
CUDA events around one launch at T = 30, B = 4096 and 256, H = 140 and 128,
median of 10 after a warm-up, with the largest |hs - plain|, |cs - plain|
of the variant as built. Builds go to `bcnf_tpu_torch/_build/k3a_parts/`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATCHES = {
    "as built": [],
    "no_exchange": [("st_cluster_f4(p, q", "if (T < 0) st_cluster_f4(p, q")],
    "no_product": [("if (tau > 0) {\n      cluster_wait();", "if (tau > 0) {\n      cluster_wait();\n      if (T > 0) goto no_product;"),
                   ("    cluster_arrive();  // (A)", "    no_product:\n    cluster_arrive();  // (A)")],
}


def variant_source(src: str, pairs: list[tuple[str, str]]) -> str:
    """The source with the patches applied inside the forward kernel and
    only the TN 4 and 5 cases dispatched."""
    a, b = src.index("lstm_fwd_kernel(const float*"), src.index("// K3b's shared-memory layout")
    body = src[a:b]
    for old, new in pairs:
        if old not in body:
            raise ValueError(f"patch target not in the forward kernel: {old!r}")
        body = body.replace(old, new)
    src = src[:a] + body + src[b:]
    for tn in (1, 2, 3, 6, 7, 8):
        src = src.replace(f"    case {tn}: CALL({tn})                        \\\n", "")
    return src


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("k3a_parts: needs a CUDA card")
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build
    from bcnf_tpu_torch.ops.lstm_kernel import lstm_direction_fwd_reference

    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "k3a_parts")
    os.makedirs(out_dir, exist_ok=True)
    repo_src = open(_build.SOURCES["lstm_kernel"]).read()
    jobs = {f"repo {name}": variant_source(repo_src, pairs) for name, pairs in PATCHES.items()}
    for path in sys.argv[1:]:
        jobs[os.path.basename(path)] = variant_source(open(path).read(), [])
    procs = {}
    for i, (name, text) in enumerate(jobs.items()):
        cu, lib = os.path.join(out_dir, f"v{i}.cu"), os.path.join(out_dir, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC), "-o", lib, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        ptxas = next((" | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 3])
                      for i, ln in enumerate(lines) if "lstm_fwd_kernelILi5" in ln), "?")
        print(f"{name}: lstm_fwd_kernel<5> {ptxas}")
        libs[name] = ctypes.CDLL(lib)
        libs[name].bcnf_lstm_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 30
    for H, Hp in ((140, 160), (128, 128)):
        w = torch.randn((H, 4 * H), generator=gen, device=dev) / H**0.5
        for B in (4096, 256):
            xp = torch.randn((T, B, 4 * H), generator=gen, device=dev)
            hs, cs = torch.empty((T, B, H), device=dev), torch.empty((T, B, H), device=dev)
            ref = lstm_direction_fwd_reference(xp, w, False)
            for name, lib in libs.items():
                def launch():
                    err = lib.bcnf_lstm_fwd(xp.data_ptr(), w.data_ptr(), hs.data_ptr(), cs.data_ptr(), T, B, H, Hp,
                                            0, torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"{name}: launch failed ({err})")
                launch()
                torch.cuda.synchronize()
                err = max((hs - ref[0]).abs().max().item(), (cs - ref[1]).abs().max().item())
                times = []
                for _ in range(10):
                    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    a.record()
                    launch()
                    b.record()
                    torch.cuda.synchronize()
                    times.append(a.elapsed_time(b))
                times.sort()
                print(f"H={H} B={B} {name:28s} {times[5]:.3f} ms (min {times[0]:.3f}); max|d| hs, cs {err:.2e}")


if __name__ == "__main__":
    main()
