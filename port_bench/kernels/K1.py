"""K1, ``kernels.mel_project_log`` (``csrc/mel_log.cu``): the log-mel tail
of the frontend, ``log(fb @ |S| + 1e-4)`` over a complex64 (B, F, T)
spectrum, float32 out.

Work these inputs need: |S| once a bin (3 operations), a multiply-add a
non-zero filterbank entry and frame, a log an output; bytes: the spectrum
(8 a bin), the filterbank and the output (4 each), each once."""

TARGET = ("freesound_classification_tpu_torch.ops.kernels",
          "mel_project_log")
DEVICE_NAMES = ("mel_log_kernel",)
PEAK_OPS = 67e12  # float32 outside the tensor cores


def capture(args, kwargs, out):
    spec, fb = args[:2]
    return {"spec": tuple(spec.shape), "fb": fb}


def work(call, nnz=None):
    b, f, t = call["spec"]
    fb = call["fb"]
    m = fb.shape[0]
    if nnz is None:
        nnz = int((fb != 0).sum())
    ops = b * t * (3 * f + 2 * nnz + m)
    n_bytes = b * f * t * 8 + fb.numel() * 4 + b * m * t * 4
    return ops, n_bytes
