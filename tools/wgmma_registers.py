#!/usr/bin/env python3
"""The registers each kernel of a library is given, from ptxas and from its
SASS: what `-Xptxas -v` reports (registers, spill stores and loads), and what
the code uses (the highest register it names, before and after its first
`setmaxnreg` raise, and its local-memory instructions, LDL and STL).

A block of 384 threads starts with 168 registers a thread (65,536 / 384).
Where a kernel's warpgroups trade registers with `setmaxnreg`, ptxas reports
that launch count; the SASS shows whether the code after the raise names
registers past it.

Run from the root of a checkout on a machine with the CUDA toolkit (no card
is needed):

    python3 tools/wgmma_registers.py [--from OTHER_CHECKOUT] [LIBRARY ...]

Each library of `ops/_build.py`'s SOURCES (default: `flow_wgmma` and
`flow_wgmma_tf32`) is compiled by nvcc from this checkout's sources (or
OTHER_CHECKOUT's) with this checkout's flags into
`bcnf_tpu_torch/_build/wgmma_registers/`, all at once, and disassembled with
`cuobjdump -sass`. Prints a line a kernel; exits 1 if a kernel spills.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ptxas_usage(log: str) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in nvcc's `-Xptxas -v` log,
    by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def sass_usage(sass: str) -> dict[str, dict]:
    """Per kernel of a `cuobjdump -sass` listing: the highest general
    register its instructions name, before and after its first
    `setmaxnreg` raise (USETMAXREG.TRY_ALLOC), its USETMAXREG lines and its
    count of LDL and STL instructions."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {"max_reg": -1, "max_reg_after_raise": -1, "setmaxreg": [], "ldl": 0, "stl": 0}
            raised = False
            continue
        if name is None or "/*" not in line:
            continue
        instr = re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip()
        if not instr or instr.startswith("/*"):
            continue
        usage = out[name]
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", instr)]
        top = max(regs, default=-1)
        usage["max_reg"] = max(usage["max_reg"], top)
        if raised:
            usage["max_reg_after_raise"] = max(usage["max_reg_after_raise"], top)
        if "SETMAXREG" in instr:
            usage["setmaxreg"].append(instr)
            raised = raised or "TRY_ALLOC" in instr
        usage["ldl"] += bool(re.search(r"\bLDL\b", instr))
        usage["stl"] += bool(re.search(r"\bSTL\b", instr))
    return out


def label(mangled: str) -> str:
    """`name<template args>` of a mangled kernel name, the anonymous
    namespace's per-file tag taken out."""
    plain = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "", mangled)
    m = re.search(r"\d+([A-Za-z_]\w*?)I((?:L[ib]\d+E)+)E", plain)
    if m is None:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"


def main() -> None:
    args = sys.argv[1:]
    root = HERE
    if args[:1] == ["--from"]:
        if len(args) < 2:
            raise SystemExit(__doc__)
        root, args = os.path.abspath(args[1]), args[2:]
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    names = args or ["flow_wgmma", "flow_wgmma_tf32"]
    if any(n not in _build.SOURCES for n in names):
        raise SystemExit(__doc__)
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "wgmma_registers")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(root, "bcnf_tpu_torch", "ops", "csrc", _build.SOURCES[name].name)
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build._flags(name), "-o", lib, src]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    spills = 0
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        ptxas = ptxas_usage(log)
        sass = sass_usage(subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout)
        print(f"{name} (from {root}):")
        for kernel, p in ptxas.items():
            s = sass.get(kernel, {})
            spills += p["spill_stores"] + p["spill_loads"] + s.get("ldl", 0) + s.get("stl", 0)
            print(f"  {label(kernel)}: ptxas {p['registers']} registers, {p['spill_stores']} bytes spill stores, "
                  f"{p['spill_loads']} bytes spill loads; SASS highest register R{s.get('max_reg')}, after the "
                  f"setmaxnreg raise R{s.get('max_reg_after_raise')}, LDL {s.get('ldl')}, STL {s.get('stl')}; "
                  f"{' | '.join(s.get('setmaxreg', [])) or 'no setmaxnreg'}", flush=True)
    sys.exit(1 if spills else 0)


if __name__ == "__main__":
    main()
