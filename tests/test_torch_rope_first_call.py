"""The first ``apply_rope`` of a fresh CPU process equals the second, bit
for bit, at llama ``debug`` widths in bf16 over [8, 2048] positions (the
angle table [8, 1, 2048, 8] f32, where a train worker's first step once
read another loss than every later forward).

ATen's first parallel float32 cos in a process can give one worker
thread's share of the elements other values; ``apply_rope`` runs one
throwaway cos first on the CPU. Each case is a fresh process, a few at
once.
"""

import os
import subprocess
import sys

PROCESSES = 12
AT_ONCE = 3    # few enough that each has the cores its thread pool expects
CODE = """
import torch
from ray_tpu_torch.ops.rope import apply_rope

g = torch.Generator().manual_seed(0)
x = torch.randn(8, 4, 2048, 16, generator=g).bfloat16()
pos = torch.arange(2048)[None].expand(8, 2048)
first = apply_rope(x, pos)
second = apply_rope(x, pos)
print(int(torch.equal(first, second)),
      (first.float() - second.float()).abs().max().item())
"""


def test_first_apply_rope_equals_the_second_in_fresh_processes():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([root,
                                           os.environ.get("PYTHONPATH", "")]))
    results = []
    for _ in range(PROCESSES // AT_ONCE):
        procs = [subprocess.Popen([sys.executable, "-c", CODE], env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(AT_ONCE)]
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            results.append(out.split())
    assert all(r[0] == "1" for r in results), results
