"""Instruction counts of a built kernel library, read from its SASS.

    python -m zoic_tpu_torch.tools.sass_count [--name raytraced]
        [--match TEXT] [--out FILE]

builds ``csrc/<name>.cu`` if it is not built, prints what ``ptxas -v``
reported at the build (registers, shared memory, spills per kernel), and
disassembles the library with ``cuobjdump -sass``.  For every kernel whose
name contains ``--match`` it prints one JSON line: the instruction total,
the count per class, and the same for every loop (a backward branch and
its target, innermost first by size), so that the element loop of the
raytraced kernel (the loop with two ``MUFU.RSQ``) can be read off.
``--out`` keeps the disassembly.

Classes: ``fadd_fmul`` (FADD, FMUL, FFMA), ``fcmp_sel`` (FSETP, FSEL,
FMNMX, FCHK), ``mufu``, ``int`` (IMAD, IADD3, LOP3, SHF, LEA, ISETP, ...),
``lds``/``sts`` (shared memory), ``ldc`` (constant bank loads; operands
read straight from the bank are part of their instruction), ``ldg``/``stg``
(global memory), ``branch`` (BRA, BSSY, BSYNC, CALL, RET, EXIT), ``warp``
(VOTE, SHFL, WARPSYNC, ...), ``other``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

from ..ops import _build

CLASSES = (
    ("fadd_fmul", ("FADD", "FMUL", "FFMA")),
    ("fcmp_sel", ("FSETP", "FSEL", "FMNMX", "FCHK", "FSET")),
    ("mufu", ("MUFU",)),
    ("cvt", ("F2I", "I2F", "I2FP", "FRND", "F2F", "F2FP")),
    ("lds", ("LDS",)),
    ("sts", ("STS",)),
    ("ldc", ("LDC", "ULDC")),
    ("ldg", ("LDG", "LD")),
    ("stg", ("STG", "ST", "ATOMG", "RED", "ATOM")),
    ("branch", ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BRX", "JMP",
                "BREAK", "WARPSYNC", "NANOSLEEP", "YIELD")),
    ("warp", ("VOTE", "VOTEU", "SHFL", "MATCH", "REDUX", "BAR", "MEMBAR",
              "ERRBAR", "DEPBAR", "CCTL")),
    ("int", ("IMAD", "IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR",
             "LEA", "ISETP", "SEL", "IMNMX", "POPC", "FLO", "PLOP3", "MOV",
             "UMOV", "UIADD3", "ULOP3", "USHF", "UISETP", "UIMAD", "ULEA",
             "USEL", "UPLOP3", "UFLO", "UPOPC", "R2UR", "S2R", "S2UR", "CS2R",
             "P2R", "R2P", "PRMT", "IABS", "BMSK", "SGXT", "UPRMT", "R2UR",
             "IDP", "UR2UP", "UP2UR")),
)
_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\d+\s+)?([A-Z0-9_.]+)"
                   r"(.*?);")


def classify(op: str) -> str:
    base = op.split(".")[0]
    for name, ops in CLASSES:
        if base in ops:
            return name
    return "other"


def parse(sass: str):
    """``{kernel name: [(address, opcode, operand text), ...]}``."""
    kernels, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernels.setdefault(m.group(1), [])
            continue
        m = _LINE.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return kernels


def counts(instrs) -> dict:
    c = collections.Counter(classify(op) for _, op, _ in instrs)
    c["mufu_rsq"] = sum(op.startswith("MUFU.RSQ") for _, op, _ in instrs)
    return dict(sorted(c.items()))


def loops(instrs):
    """``[(start, end)]`` address ranges of the backward branches."""
    out = []
    for addr, op, rest in instrs:
        if op.split(".")[0] != "BRA":
            continue
        m = re.search(r"0x([0-9a-f]+)", rest)
        if m and int(m.group(1), 16) <= addr:
            out.append((int(m.group(1), 16), addr))
    return sorted(out, key=lambda r: r[1] - r[0])


def report(name: str, instrs) -> dict:
    rows = []
    for lo, hi in loops(instrs):
        body = [i for i in instrs if lo <= i[0] <= hi]
        rows.append({"from": hex(lo), "to": hex(hi), "instructions": len(body),
                     **counts(body)})
    return {"kernel": name, "instructions": len(instrs), **counts(instrs),
            "loops": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--name", default="raytraced")
    ap.add_argument("--match", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    _build.load(args.name)
    lib = _build.library_path(args.name)
    with open(f"{lib}.ptxas.txt") as f:
        print(f.read(), file=sys.stderr)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"cuobjdump failed: {proc.stderr}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(proc.stdout)
    for name, instrs in parse(proc.stdout).items():
        if args.match in name:
            print(json.dumps(report(name, instrs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
