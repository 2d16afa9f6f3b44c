"""The vertex attention's bound time (frozen yardstick): what its roofline
share divides by.

The work is the published math counted once per (sample, vertex) pair,
whatever implements it (ops/vertex_attention.py makes two passes over the
vertices, a fused kernel one):

  distance  3 subtractions, 1 multiply + 2 fused multiply-adds, 1 sqrt
  activation  warp_radius - d (1 add), relu (1 max), * temperature (1 multiply)
  exp       att - M (1 add), the scale to base 2 (1 multiply), 1 ex2
  sums      sum_v e (1 add), sum_v e * warp_v (3 fused multiply-adds)

so 15 FP32-pipe instructions (a fused multiply-add counts once) and 2
special-function instructions (sqrt as MUFU.RSQ, exp as MUFU.EX2) a pair.
The -exp(-M) term and the division are per sample, not per pair: left out.

Rates: one NVIDIA H100 SXM5 (132 SMs), per SM and clock 128 FP32 results and
16 special-function results (CUDA C++ Programming Guide, "Arithmetic
Instructions", compute capability 9.0), at the card's maximum SM clock of
1,980 MHz (NVIDIA H100 data sheet; `nvidia-smi --query-gpu=clocks.max.sm`
reads 1980 on the benchmark's card). The bound is the larger of the two
pipes' times: at a 2048-ray step of 64 samples over 6,890 vertices, about
0.43 ms (special functions) against 0.41 ms (FP32).
"""
from __future__ import annotations

SMS = 132
CLOCK_HZ = 1.98e9
FP32_PER_SM_CLOCK = 128
SFU_PER_SM_CLOCK = 16
FP32_PER_PAIR = 6 + 3 + 2 + 4                 # distance, activation, exp, sums
SFU_PER_PAIR = 2                             # sqrt, exp


def pairs_per_step(flags: dict, vertices: int) -> int:
    """(sample, vertex) pairs of one training step's attention."""
    return int(flags["batchsize"]) * int(flags["number_coarse_samples"]) * int(vertices)


def attention_bound_s(pairs: float) -> float:
    """Seconds the H100 needs at least for `pairs` pairs of the attention."""
    fp32 = pairs * FP32_PER_PAIR / (SMS * FP32_PER_SM_CLOCK * CLOCK_HZ)
    sfu = pairs * SFU_PER_PAIR / (SMS * SFU_PER_SM_CLOCK * CLOCK_HZ)
    return max(fp32, sfu)
