#!/usr/bin/env python3
"""Every kernel this checkout builds against another checkout's build of the
same library, instruction for instruction: where the SASS of a kernel is the
same, so are its outputs, to the bit, on any input.

Run from the root of a checkout on a machine with the CUDA toolkit (no card
is needed), naming the other checkout's root (for instance a `git archive`
of the parent commit unpacked into a directory that .gitignore lists):

    python3 tools/sass_against.py OTHER_CHECKOUT [LIBRARY ...]

Each library of `ops/_build.py`'s SOURCES (default: every one both
checkouts have) is compiled by nvcc from each checkout's sources with this
checkout's flags into `bcnf_tpu_torch/_build/sass_against/`, all at once,
and disassembled with `cuobjdump -sass`. Kernels are matched by name (the
anonymous namespace's per-file tag taken out) and their instructions
compared; prints, per library, the kernels that are the same, those that
differ, and those that only one checkout has. Exits 1 if a kernel both
have differs.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernels(sass: str) -> dict[str, str]:
    """The SASS of each kernel in a cuobjdump listing, by its name with the
    anonymous namespace's per-file tag taken out."""
    out, name, body = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name is not None:
                out[name] = "\n".join(body)
            name, body = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", m.group(1)), []
        elif name is not None and "/*" in line:
            # the instruction and its encoding, without its address or the listing's padding (cuobjdump pads
            # every line of a file to its longest instruction)
            body.append(" ".join(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split()))
    if name is not None:
        out[name] = "\n".join(body)
    return out


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    sys.path.insert(0, HERE)
    from bcnf_tpu_torch.ops import _build

    names = sys.argv[2:] or [n for n, p in _build.SOURCES.items()
                             if os.path.exists(os.path.join(other, "bcnf_tpu_torch", "ops", "csrc", p.name))]
    out_dir = os.path.join(HERE, "bcnf_tpu_torch", "_build", "sass_against")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for root, tag in ((HERE, "this"), (other, "other")):
        for name in names:
            src = os.path.join(root, "bcnf_tpu_torch", "ops", "csrc", _build.SOURCES[name].name)
            lib = os.path.join(out_dir, f"{tag}_{name}.so")
            cmd = [_build._nvcc(), *_build._flags(name), "-o", lib, src]
            procs[(tag, name)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    listing = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {key}:\n{log}")
        listing[key] = kernels(subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                                              check=True).stdout)
    differ = 0
    for name in names:
        this, that = listing[("this", name)], listing[("other", name)]
        same = [k for k in this if k in that and this[k] == that[k]]
        changed = [k for k in this if k in that and this[k] != that[k]]
        differ += len(changed)
        print(f"{name}: {len(same)} kernels the same, {len(changed)} differ {changed}; only here "
              f"{sorted(set(this) - set(that))}; only in the other {sorted(set(that) - set(this))}", flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
