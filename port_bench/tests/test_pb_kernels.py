"""The kernel entries' operation and byte counts give the bounds that the
port's records list for K1-K3 (PERF.md's table of kernels: K1 0.1436 ms at
128 x 10 s by bytes, K2 0.0439 ms masked and 0.0494 ms unmasked by bytes at
48 x 441000, K3 0.1763 ms by operations at 48 rows of 10 s)."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness, spec
from port_bench.reference.frontend import mel_filterbank

ENTRIES = spec.kernel_entries()
L10 = 441000  # 10 s at 44.1 kHz
CHAIN_ROWS = 48  # round(0.75 * 64), the chain's rows of a 64-clip batch


def bound_ms(entry, call) -> tuple:
    ops, n_bytes = entry.work(call)
    t_bytes, t_ops = n_bytes / harness.PEAK_HBM, ops / entry.PEAK_OPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "ops"


def test_k1_bound():
    fb = torch.from_numpy(mel_filterbank(44100, 2048, 128))
    call = {"spec": (128, 1025, L10 // 1024 + 1), "fb": fb}
    ms, by = bound_ms(ENTRIES["K1"], call)
    assert (round(ms, 4), by) == (0.1436, "bytes")


def test_k3_bound():
    n_fft, hop = 1024, 256
    t_in = L10 // hop + 1
    call = {"mag": (CHAIN_ROWS, t_in, n_fft // 2 + 1),
            "dphi": CHAIN_ROWS * (t_in - 1) * (n_fft // 2 + 1),
            "phase0": CHAIN_ROWS * (n_fft // 2 + 1),
            "basis": (n_fft // 2 + 1, n_fft), "hop": hop,
            "t_out": (L10 + n_fft // 2) // hop + 2}
    ms, by = bound_ms(ENTRIES["K3"], call)
    assert (round(ms, 4), by) == (0.1763, "ops")


def k2_call(device, masked: bool) -> dict:
    """K2's inputs as the port's kernel probe draws them: speed U(0.9, 1.1)
    x 2^(cents / 1200), |cents| < 300, lengths of half to all of a row."""
    gen = torch.Generator(device=device).manual_seed(2)
    factor = (0.9 + 0.2 * torch.rand(CHAIN_ROWS, device=device,
                                     generator=gen)) \
        * torch.exp2((600 * torch.rand(CHAIN_ROWS, device=device,
                                       generator=gen) - 300) / 1200)
    lengths = torch.randint(L10 // 2, L10 + 1, (CHAIN_ROWS,), device=device,
                            generator=gen, dtype=torch.int32)
    return {"shape": (CHAIN_ROWS, L10), "factor": factor,
            "lengths": lengths if masked else None}


@pytest.mark.parametrize("masked,want", [(True, 0.0439), (False, 0.0494)])
def test_k2_bound_on_the_cpu_draws(masked, want):
    """The CPU's generator draws other numbers from the same seed: the
    bound lands within 3 % of the record's."""
    ms, by = bound_ms(ENTRIES["K2"], k2_call("cpu", masked))
    assert by == "bytes" and abs(ms - want) <= 0.03 * want


@pytest.mark.card
@pytest.mark.parametrize("masked,want", [(True, 0.0439), (False, 0.0494)])
def test_k2_bound_on_the_card(card, masked, want):
    ms, by = bound_ms(ENTRIES["K2"], k2_call(card, masked))
    assert (round(ms, 4), by) == (want, "bytes")


def test_entries_name_their_targets_and_kernels():
    import importlib

    for name, entry in ENTRIES.items():
        module = importlib.import_module(entry.TARGET[0])
        assert callable(getattr(module, entry.TARGET[1])), name
        assert entry.DEVICE_NAMES and entry.PEAK_OPS > 0
