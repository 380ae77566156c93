"""The port's CUDA kernels (``csrc/``), their wrappers, plain versions and
route wrappers.  Flash attention is not ported yet."""
from . import ops, ref
from ._build import KERNELS, build_all, launches, reset_launches
from .conv2d import conv2d_cuda, conv2d_plain, conv2d_q16_cuda, conv2d_q16_plain
from .matmul_fp import matmul_fp_cuda, matmul_fp_plain
from .matmul_q16 import matmul_q16_cuda, matmul_q16_plain
