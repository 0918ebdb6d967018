"""Instructions per loop of the built kernels, from their SASS.

    python -m motionestimation_tpu_torch.tools.sass_loops SOURCE [--match S]

Builds csrc/SOURCE.cu if needed, disassembles the library with the CUDA
toolkit's `cuobjdump -sass` and prints, for each kernel whose mangled name
contains one of the --match strings (every kernel without --match), each
loop (a branch back to a lower address) with its instruction count and its
most frequent opcodes. In a search kernel the loop that holds the `IDP`
(`__dp4a`) and `LDS` (shared load) instructions is the candidate loop: its
count is the instructions each lane issues per candidate. Needs the toolkit
(the card's machine), not a card.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

from motionestimation_tpu_torch.kernels import _build

_FUNCTION = re.compile(r"\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """{mangled kernel name: [(address, instruction), ...]} of a dump."""
    out, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = out.setdefault(m.group(1), [])
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(instruction: str) -> str:
    """The opcode without its predicate and modifiers: "@!P0 BRA 0x10" ->
    "BRA", "IDP.4A.U8.U8 R1, ..." -> "IDP"."""
    words = instruction.split()
    if words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0]


def loops(instructions: list[tuple[int, str]]):
    """[(start, end, count, Counter of opcodes)] for each backward branch,
    in address order: the instructions from its target to the branch."""
    index = {a: k for k, (a, _) in enumerate(instructions)}
    found = []
    for k, (address, text) in enumerate(instructions):
        m = _TARGET.search(text)
        if m is None:
            continue
        target = int(m.group(1), 16)
        if target < address and target in index:
            body = instructions[index[target] : k + 1]
            found.append((target, address, len(body),
                          collections.Counter(opcode(t) for _, t in body)))
    return found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("source", choices=_build.sources())
    p.add_argument("--match", nargs="*", default=[],
                   help="substrings of the mangled kernel names to show")
    p.add_argument("--top", type=int, default=12,
                   help="opcodes to list per loop")
    args = p.parse_args(argv)
    _build.build([args.source])
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(_build.library_path(args.source))],
        capture_output=True, text=True, check=True,
    ).stdout
    for name, instructions in functions(sass).items():
        if args.match and not any(s in name for s in args.match):
            continue
        print(f"{name}: {len(instructions)} instructions")
        for start, end, count, ops in loops(instructions):
            top = ", ".join(f"{o} {c}" for o, c in ops.most_common(args.top))
            print(f"  loop {start:#x}..{end:#x}: {count} instructions; {top}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
