"""Peak rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at
the full 700 W power limit): 67 TFLOP/s in float32 outside the tensor
cores and 67 TFLOP/s in float64 on the tensor cores, both 33.5e12 fused
multiply-adds a second, and 3.35 TB/s of HBM3.  The data sheet gives no
rate for the ALU pipe that runs an f32 compare, max or select: that is the
CUDA C++ Programming Guide's 64 a clock on each SM of compute capability
9.0, times 132 SMs, times the SM clock nvidia-smi reports (clocks.max.sm)."""

FMA_PER_S = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12
SMS = 132
ALU_PER_CLOCK_PER_SM = 64


def alu_per_s(sm_clock_mhz):
    return ALU_PER_CLOCK_PER_SM * SMS * float(sm_clock_mhz) * 1e6
