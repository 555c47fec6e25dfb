#!/usr/bin/env python3
"""Compare the SASS of CUDA sources of the port between two trees.

    python3 experiments/torch_sass_diff.py --old build/parent \\
        [--new .] [--source pspde_torch/csrc/stopped_rollout.cu \\
        --source pspde_torch/csrc/stopped_bwd_lanes.cu] \\
        [--dropped stopped_bwd_kernel:5]

Compiles each ``--source`` (default: stopped_rollout.cu) that a tree has
with nvcc for sm_90a (the flags of ``pspde_torch/rollout/_build.py``) into
a cubin, reads ``cuobjdump -sass``, takes the kernels of all of a tree's
sources together (so that a kernel moved to a source of its own pairs with
its old self), and pairs every kernel of the old tree with the new kernel
of the same name
whose template arguments extend the old ones by ``false`` (a template
parameter added after the old ones, at its value for the old family: e.g.
``stopped_fwd_kernel<false>`` and ``stopped_fwd_kernel<false, false,
false>``; the stopped backward's memory plan, ``kDevice``, appended
with ``false`` for the shared plan, renamed each of the older backward's
instantiations so, and the Schroedinger family and the tanh features,
``kSch`` and ``kTanh``, appended last to both stopped kernels, rename
every earlier instantiation to the name ending in ``false, false``).
``--dropped NAME:POS`` pairs the other way where the new tree dropped a
template parameter: an old instantiation of NAME whose argument at
position POS (from 0) is ``false`` pairs with the new one without it, and
one with another value there has no counterpart (the stopped backward's
``kDevice``, position 5, went when the device plan moved to a kernel of
its own).  It prints that name map first, old -> new (or "no
counterpart"), then for each pair the instruction counts and the count of
instructions that differ (addresses and encodings stripped; a line that
differs only in a branch target's address still counts), and one JSON line
last.  Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt).
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pspde_torch.rollout import _build  # noqa: E402


def sass_of(source: str) -> dict:
    """{demangled kernel name: [instruction text]} of one source."""
    nvcc = _build._nvcc()
    tools = os.path.dirname(nvcc)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-cubin", "-I",
                        os.path.dirname(source), "-o", cubin, source],
                       check=True)
        sass = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass",
                               cubin], capture_output=True, text=True,
                              check=True).stdout
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*(/\*.*)?$", line)
        if name is not None and m and m.group(1):
            kernels[name].append(m.group(1).rstrip(" ;"))
    names = list(kernels)
    demangled = subprocess.run(
        [os.path.join(tools, "cu++filt")], input="\n".join(names),
        capture_output=True, text=True, check=True).stdout.splitlines()
    return {dm.strip(): kernels[n] for n, dm in zip(names, demangled)}


def split_template(name: str):
    """'void (anonymous namespace)::f<a, b>(args)' -> ('f', ['a', 'b'])."""
    m = re.search(r"(\w+)<([^<>]*)>", name)
    if not m:
        return name, []
    # cu++filt writes a bool template argument as (bool)0 / (bool)1
    spell = {"(bool)0": "false", "(bool)1": "true"}
    return m.group(1), [spell.get(a.strip(), a.strip())
                        for a in m.group(2).split(",")]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old", required=True, help="root of the old tree")
    ap.add_argument("--new", default=ROOT, help="root of the new tree")
    ap.add_argument("--source", action="append", default=[],
                    help="a source, relative to each tree's root (repeat "
                         "for several; default stopped_rollout.cu)")
    ap.add_argument("--dropped", action="append", default=[],
                    metavar="NAME:POS",
                    help="a template parameter the new tree dropped")
    args = ap.parse_args()
    dropped = {}
    for spec in args.dropped:
        kernel, pos = spec.rsplit(":", 1)
        dropped.setdefault(kernel, []).append(int(pos))
    sources = args.source or ["pspde_torch/csrc/stopped_rollout.cu"]

    def kernels_of(root):
        out = {}
        for src in sources:
            path = os.path.join(root, src)
            if os.path.isfile(path):
                out.update(sass_of(path))
        return out

    old, new = kernels_of(args.old), kernels_of(args.new)
    new_by_key = {}
    for name in new:
        base, targs = split_template(name)
        new_by_key[(base, tuple(targs))] = name
    name_map = {}
    for name in old:
        base, targs = split_template(name)
        name_map[name] = None
        if base in dropped:
            if any(targs[p] != "false" for p in dropped[base]):
                continue
            targs = [a for i, a in enumerate(targs)
                     if i not in dropped[base]]
        for (nb, nt), nname in new_by_key.items():
            if (nb == base and len(nt) >= len(targs)
                    and list(nt[:len(targs)]) == targs
                    and all(a == "false" for a in nt[len(targs):])):
                name_map[name] = nname
    print("name map, old -> new:")
    for name, match in name_map.items():
        print(f"  {split_template(name)} -> "
              f"{split_template(match) if match else 'no counterpart'}")
    pairs = []
    for name, code in old.items():
        match = name_map[name]
        if match is None:
            print(f"{name}: no counterpart in the new tree")
            pairs.append({"old": name, "new": None})
            continue
        diff = [ln for ln in difflib.unified_diff(code, new[match], n=0,
                                                  lineterm="")
                if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        n_diff = sum(1 for ln in diff if ln.startswith("+"))
        print(f"{name} -> {match}: {len(code)} -> {len(new[match])} "
              f"instructions, {n_diff} added or changed, "
              f"{sum(1 for ln in diff if ln.startswith('-'))} removed or "
              f"changed; identical: {code == new[match]}")
        for ln in diff[:40]:
            print(f"    {ln}")
        pairs.append({"old": name, "new": match, "n_old": len(code),
                      "n_new": len(new[match]), "changed": n_diff,
                      "identical": code == new[match]})
    print(json.dumps({"sources": sources, "pairs": pairs,
                      "name_map": name_map, "new_kernels": sorted(new)}))


if __name__ == "__main__":
    main()
