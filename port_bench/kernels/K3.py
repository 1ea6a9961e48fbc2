"""K3, ``kernels.pv_resynth`` (``csrc/pv_resynth.cu``, three kernels): the
phase-vocoder resynthesis of the effects chain's stretch: magnitudes and
phases at the output frames, the bf16 inverse-rDFT product and the
overlap-add.

Work: the synthesis product, 2 operations a multiply-add of the (B * rows,
2F) x (2F, n_fft) product on the bf16 tensor cores; bytes: magnitudes,
phase steps, first phases and rates (4 each), the bf16 cos and sin bases
(2 each), the float32 (B, rows, hop) output, each once."""

TARGET = ("freesound_classification_tpu_torch.ops.kernels", "pv_resynth")
DEVICE_NAMES = ("pv_tile_sum_kernel", "pv_resynth_kernel",
                "pv_ola_fix_kernel")
PEAK_OPS = 989e12  # bf16 tensor cores


def capture(args, kwargs, out):
    mag, dphi, phase0, rate, icos, isin, hop, t_out = args[:8]
    return {"mag": tuple(mag.shape), "dphi": dphi.numel(),
            "phase0": phase0.numel(), "basis": tuple(icos.shape),
            "hop": int(hop), "t_out": int(t_out)}


def work(call):
    b, t_in, f = call["mag"]
    n_bins, n_fft = call["basis"]
    hop = call["hop"]
    rows = call["t_out"] + n_fft // hop - 1
    n_bytes = ((b * t_in * f + call["dphi"] + call["phase0"] + b) * 4
               + 2 * n_bins * n_fft * 2 + b * rows * hop * 4)
    return 2 * b * rows * 2 * f * n_fft, n_bytes
