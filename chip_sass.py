#!/usr/bin/env python3
"""What ptxas made of a kernel's innermost loop, read from its SASS.

    python3 chip_sass.py [--root DIR] [--source sweep_topk_f32] [--kernel SUBSTR]

Compiles `DIR/cozo_tpu_torch/csrc/<source>.cu` (default: this checkout's
`sweep_topk_f32.cu`) with the port's nvcc flags into a cubin, disassembles
it with `cuobjdump -sass` and, for every kernel whose name holds SUBSTR,
finds its hottest loop (the backward branch whose body holds the most
FFMAs) and prints, for that body (`--dump FILE` also appends its SASS
there): its instructions by opcode, the FFMA share of the issue slots, the shared loads by width, the FFMA source
operands read through the reuse cache, the FFMAs whose source registers
left to the register file meet in one bank (bank = register % 2: two
sources, or all three), and for every shared load the distance in
instructions from it to the first instruction that reads what it loaded
(a short distance is latency that only other warps can cover).  It also
prints ptxas's registers and spills.  Needs `nvcc` and `cuobjdump` (the
CUDA toolkit), but with `--sass FILE`; it runs nothing on a card.
"""

import argparse
import collections
import os
import re
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
REG = re.compile(r"\bR(\d+)(\.reuse)?")


def parse(sass):
    """{function: [(address, opcode, operand text)]} of cuobjdump's text."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = LINE.search(line)
        if m and cur is not None:
            text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            op, _, rest = text.partition(" ")
            cur.append((int(m.group(1), 16), op, rest))
    return funcs


def width(op):
    """Registers an instruction writes (its vector width)."""
    return {"128": 4, "64": 2}.get(op.rsplit(".", 1)[-1], 1)


def hot_loop(ins):
    """(first, last) indices of the innermost loop (no backward branch
    inside it) with the most FFMAs."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    loops = []
    for i, (_, op, rest) in enumerate(ins):
        m = re.match(r"0x([0-9a-f]+)", rest.strip())
        j = at.get(int(m.group(1), 16)) if op.startswith("BRA") and m else None
        if j is not None and j <= i:
            loops.append((j, i))
    inner = [(j, i) for j, i in loops
             if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                        for j2, i2 in loops)]
    return max(inner, default=None, key=lambda s: sum(
        o.startswith("FFMA") for _, o, _ in ins[s[0]:s[1] + 1]))


def report(name, ins, dump=None):
    span = hot_loop(ins)
    if span is None:
        print(f"{name}: no loop")
        return
    body = ins[span[0]:span[1] + 1]
    if dump:
        with open(dump, "a") as f:  # in cuobjdump's form, for --sass
            f.write(f"\tFunction : {name}\n")
            f.writelines(f"        /*{a:04x}*/ {op} {rest} ;\n"
                         for a, op, rest in body)
    ops = collections.Counter(op.split(".")[0] for _, op, _ in body)
    n_ffma = ops["FFMA"]
    lds = collections.Counter(op for _, op, _ in body if op.startswith("LDS"))
    reused = two = three = 0
    for _, op, rest in body:
        if not op.startswith("FFMA"):
            continue
        srcs = REG.findall(rest)[1:]
        reused += sum(1 for _, r in srcs if r)
        banks = collections.Counter(int(n) % 2 for n, r in srcs if not r)
        top = max(banks.values(), default=0)
        two += top >= 2
        three += top >= 3
    dist = []
    for i, (_, op, rest) in enumerate(body):
        regs = REG.findall(rest)
        if not op.startswith("LDS") or not regs:
            continue
        base = int(regs[0][0])
        dst = set(range(base, base + width(op)))
        for k, (_, _, later) in enumerate(body[i + 1:], 1):
            if dst & {int(n) for n, _ in REG.findall(later.split(",", 1)[-1])}:
                dist.append(k)
                break
    print(f"{name}: hottest loop {len(body)} instructions "
          f"(0x{body[0][0]:x}-0x{body[-1][0]:x}), FFMA {n_ffma} = "
          f"{n_ffma / len(body):.1%} of the slots; shared loads "
          f"{dict(lds)}; by opcode {dict(ops.most_common(12))}")
    print(f"  FFMA sources through the reuse cache {reused} of "
          f"{3 * n_ffma}; FFMAs with two register-file sources in one bank "
          f"{two}, with three {three}")
    if dist:
        print(f"  shared load -> first use, instructions: min {min(dist)}, "
              f"median {statistics.median(dist)}, max {max(dist)}, "
              f"under 8: {sum(d < 8 for d in dist)} of {len(dist)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--source", default="sweep_topk_f32")
    ap.add_argument("--kernel", default="sweep_topk_f32_kernel")
    ap.add_argument("--dump", help="append each hottest loop's SASS here")
    ap.add_argument("--sass", help="read this SASS (cuobjdump's text, or a "
                    "--dump) instead of building; needs no toolkit")
    args = ap.parse_args()
    if args.sass:
        with open(args.sass) as f:
            for name, ins in sorted(parse(f.read()).items()):
                if args.kernel in name:
                    report(name, ins)
        return 0
    from cozo_tpu_torch.ops import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = os.path.join(args.root, "cozo_tpu_torch", "csrc",
                       args.source + ".cu")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        proc = subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-o",
                               cubin, src], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:])
            return 1
        for line in proc.stderr.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {args.root}: {line.strip()[:200]}")
        tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
        sass = subprocess.run([tool, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    for name, ins in sorted(parse(sass).items()):
        if args.kernel in name:
            report(name, ins, args.dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
