#!/usr/bin/env python3
"""Compare the SASS of the port's CUDA kernels between this checkout and
another one (such as a parent commit unpacked with ``git archive``), kernel
by kernel, on the machine with the card:

    python3 sass_diff.py OTHER_CHECKOUT [SOURCE ...]   # default: every csrc/*.cu

Each checkout builds its own ``csrc/<source>.cu`` with its own ``_build.py``
(both at once) and ``cuobjdump -sass`` dumps both libraries.  A kernel of
OTHER's library is "same" where this checkout's library holds a kernel of
the same mangled name (but for the hash of its source's anonymous
namespace), or of that name with one more trailing ``false``
template argument (a flag added since, switched off), whose SASS is
identical line for line (blanks and branch labels normalised); a
kernel with no such name is "same" where a kernel here has its SASS line
for line (one whose signature gained trailing parameters).  Prints one
JSON line a source (the kernels that are the same, differ or are missing,
and this checkout's new kernels) and exits 1 if any of OTHER's kernels
differs or is missing.
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
_BUILD = ("import json, sys; from cugraph_gnn_tpu_torch import _build; "
          "print(json.dumps({k: str(b.path) for k, b in _build.build(sys.argv[1:]).items()}))")


def cuobjdump() -> str:
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    found = str(path) if path.exists() else shutil.which("cuobjdump")
    if found is None:
        sys.exit("sass_diff: no cuobjdump")
    return found


def kernels(lib: str) -> dict:
    """Mangled kernel name -> its SASS lines, runs of blanks made one and
    branch labels renumbered in their order in the kernel (cuobjdump pads
    every line to the library's longest and numbers labels across the whole
    library, so a kernel added or changed elsewhere shifts both)."""
    out = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(" ".join(line.split()))
    for name, lines in funcs.items():
        labels = {}
        funcs[name] = [re.sub(r"\.L_x_\d+", lambda l: labels.setdefault(
            l.group(0), f".L_{len(labels)}"), line) for line in lines]
    return funcs


def plain(name: str) -> str:
    """The name without the hash that nvcc gives a source's anonymous
    namespace (it follows the source's text)."""
    return re.sub(r"(_GLOBAL__N__(?:\d+_\w+?_cu_)?)[0-9a-f]{8}", r"\1", name)


def without_last_false(name: str) -> str:
    """The name with its last template argument dropped where that is
    ``false`` (``Lb0E`` just before the closing ``EE`` of a kernel in a
    namespace)."""
    return re.sub(r"Lb0E(EEv)", r"\1", name)


def main() -> None:
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    other = Path(sys.argv[1]).resolve()
    names = sys.argv[2:] or sorted(p.stem for p in (HERE / "cugraph_gnn_tpu_torch/csrc")
                                   .glob("*.cu"))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, *names], cwd=root,
                              stdout=subprocess.PIPE, text=True) for root in (HERE, other)]
    libs = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode:
            sys.exit(f"sass_diff: a build failed ({p.args[-len(names):]})")
        libs.append(json.loads(out.strip().splitlines()[-1]))
    bad = False
    for name in names:
        new, old = ({plain(k): v for k, v in kernels(lib[name]).items()} for lib in libs)
        twin = {without_last_false(k): k for k in new}
        body = {tuple(v): k for k, v in new.items()}
        res = {"source": name, "same": [], "differ": [], "missing": []}
        matched = set()
        for k, sass in old.items():
            n = k if k in new else twin.get(k, body.get(tuple(sass)))
            matched.add(n)
            res["missing" if n is None else "same" if new[n] == sass else "differ"].append(k)
        res["new"] = sorted(set(new) - matched)
        bad |= bool(res["differ"] or res["missing"])
        print(json.dumps({**{k: len(v) if k == "same" else v for k, v in res.items()},
                          "kernels_other": len(old), "kernels_here": len(new)}))
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
