"""What nvcc makes of the port's kernels: ptxas's registers, spills and shared
memory per kernel of chosen sources, and the SASS instruction mix of kernel
K5's mask generator.

    python -m vqvae3d_tpu_torch.utils.sass_report [source.cu ...]

For each ``csrc`` source named (default: K5's two), it compiles the source with
``ops/_build.py``'s flags plus ``-Xptxas -v`` and prints one line a kernel.
Then it compiles two probe kernels over ``csrc/dropout_tc.cuh`` (one
``philox_keyed`` call on precomputed round keys; one lane's
``lane_keep_word`` of a 64-key tile, 8 calls) to a cubin, disassembles it with
``cuobjdump -sass`` and prints each probe's instruction count by opcode.
Needs ``nvcc`` and ``cuobjdump`` (a machine with the CUDA toolkit); writes
only into a temporary directory.
"""
from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from vqvae3d_tpu_torch.ops import _build

PROBE = r'''
#include "dropout_tc.cuh"
extern "C" __global__ void philox_one(const int64_t* seed, uint4* out, uint32_t n) {
  const vq::PhiloxKeys keys =
      vq::philox_round_keys(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  out[threadIdx.x] = vq::philox_keyed(make_uint4(threadIdx.x, blockIdx.x, n, 0u), keys);
}
extern "C" __global__ void lane_word(const int64_t* seed, uint32_t* out, uint32_t n,
                                     uint32_t thr, int kt) {
  const vq::PhiloxKeys keys =
      vq::philox_round_keys(static_cast<uint32_t>(seed[0]), static_cast<uint32_t>(seed[1]));
  out[threadIdx.x] = vq::dtc::lane_keep_word(kt, threadIdx.x & 3, blockIdx.x, n, keys, thr);
}
'''


def _run(cmd) -> str:
    out = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed:\n{out.stdout}")
    return out.stdout


def ptxas_lines(src: Path, work: Path):
    """(kernel, registers, spill bytes, shared bytes) of each kernel in src."""
    out = _run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                "-o", str(work / f"{src.stem}.o")])
    rows, name, spill = [], None, 0
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill, int(m.group(2))))
            name = None
    return rows


def sass_mix(work: Path) -> dict:
    """{probe kernel: Counter of SASS opcodes}."""
    cu = work / "philox_probe.cu"
    cu.write_text(PROBE)
    cubin = work / "philox_probe.cubin"
    _run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-cubin", str(cu),
          "-o", str(cubin)])
    fn, mix = None, collections.defaultdict(collections.Counter)
    for line in _run(["cuobjdump", "-sass", str(cubin)]).splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            mix[fn][m.group(2)] += 1
    return mix


def main(argv) -> int:
    sources = argv or ["flash_dropout_attention.cu", "flash_dropout_attention_bwd.cu"]
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name in sources:
            for kernel, regs, spill, smem in ptxas_lines(_build.CSRC_DIR / name, work):
                print(f"{name}: {kernel}: {regs} registers, {spill} bytes spilled, "
                      f"{smem} bytes shared")
        for fn, mix in sass_mix(work).items():
            print(f"SASS {fn}: {sum(mix.values())} instructions: "
                  + ", ".join(f"{op} {c}" for op, c in mix.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
