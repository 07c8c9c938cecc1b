"""VGG-16 / CIFAR-10-class — the PAPER's own workload (Table II: I = 16).
The port's copy of ``repro/configs/vgg16_sl.py``.

Not a language-model config; used by the paper-reproduction benchmarks
(Figs. 1, 4-8), the split-learning executor and the edge-network
integration tests.  Simulation defaults mirror Table II."""

from repro_torch.core.profiles import vgg16_profile

# Table II defaults
B_MINIBATCH = 512
B0_MICRO = 20
THETA = 0.01
KAPPA = 1.0 / 32.0      # FLOPs/byte
B_TH = 32               # [b_th^c, b_th^s]
T0 = 1e-3               # t_0^c / t_0^s
T1 = 1e-3               # t_1^c / t_1^s
N_SERVERS_DEFAULT = 6
F_RANGE = (1e12, 10e12)             # 1-10 TFLOPS
BW_LOW_HZ = (10e6, 50e6)            # 5G sub-6GHz per-link bandwidth
BW_HIGH_HZ = (100e6, 200e6)         # 5G mmWave per-link bandwidth
MEM_RANGE = (2 * 2**30, 16 * 2**30)  # 2-16 GB
POWER_W = (0.1, 0.5)                # 100-500 mW
GAMMA = 3.5
NOISE_DBM_HZ = -174.0


def profile():
    """w_i in bytes so that kappa = 1/32 FLOPs/byte recovers FLOPs (Eq. 2)."""
    return vgg16_profile(work_units="bytes")
