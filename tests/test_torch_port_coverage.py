"""The port still covers the JAX package, read from the sources with ``ast``
alone (neither package is imported).

``COUNTERPARTS`` holds every public top-level function and class of a JAX
module that has no function or class of the same name in the port module of
the same path, with what stands for it: the port's counterpart
(``module:name``, a method as ``module:Class.method``), a TPU lowering the
port leaves out (with why), or a CLI-internal helper (with the port's
function that does the work). ``KERNELS`` holds every ``pl.pallas_call``
site outside the port and the tests, with the port's hand-written wrapper in
``ops/kernels.py`` and its name in ``chip_smoke.WRAPPER_KERNEL``.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = "freesound_classification_tpu"
PORT = "freesound_classification_tpu_torch"
TPU = "TPU lowering"
CLI = "CLI-internal"

# (JAX module, name) -> the port's "module:name", or (TPU, why), or
# (CLI, the port's "module:name" that does the work)
COUNTERPARTS = {
    # ported under another name: the augmentations as draw/apply pairs
    ("ops/augment.py", "cutout"): "ops/augment.py:apply_cutout",
    ("ops/augment.py", "effects_chain"): "ops/augment.py:apply_effects",
    ("ops/augment.py", "flip"): "ops/augment.py:apply_flip",
    ("ops/augment.py", "mixup_or"): "ops/augment.py:apply_mixup_or",
    ("ops/augment.py", "reverb"): "ops/freeverb.py:reverb_batch",
    ("ops/augment.py", "sample_segment"):
        "ops/augment.py:apply_sample_segment",
    ("ops/augment.py", "shuffle_chunks"):
        "ops/augment.py:apply_shuffle_chunks",
    ("ops/augment.py", "tta_perturb"): "ops/augment.py:apply_tta_perturb",
    # featurization
    ("ops/dsp.py", "compute_stft_descriptor"): "ops/dsp.py:featurize",
    ("ops/dsp.py", "compute_stft_host"): "ops/dsp.py:log_stft_spectrogram",
    ("ops/dsp.py", "frame_signal"):
        (TPU, "framing by shifted reshapes for the MXU block-DFT; the port "
              "frames inside torch.stft (ops/dsp.py:stft)"),
    ("ops/dsp.py", "hann_window"): "ops/dsp.py:stft",
    ("ops/dsp.py", "is_mel"): "ops/dsp.py:parse_features",
    ("ops/dsp.py", "is_stft"): "ops/dsp.py:parse_features",
    ("ops/dsp.py", "make_mel_filterbanks"): "ops/dsp.py:mel_filterbank",
    ("ops/dsp.py", "stft_magnitude"): "ops/dsp.py:stft",
    ("ops/dsp.py", "stft_spectrum_dft"):
        (TPU, "the block-DFT STFT as MXU matmuls; the port calls "
              "torch.stft"),
    ("ops/freeverb.py", "wet_response_split"):
        (TPU, "the wet response's FFT split into real matmuls for the MXU; "
              "the port calls torch.fft (ops/freeverb.py:wet_response)"),
    ("ops/freeverb.py", "wet_response_split_scrambled"):
        (TPU, "the same in the MXU FFT's scrambled bin order"),
    ("ops/metrics.py", "lwlrap_jax"): "ops/metrics.py:lwlrap_torch",
    # the radix-split matmul FFT: torch.fft on the card
    **{("ops/mxu_fft.py", name):
        (TPU, "the FFT as radix-split matmuls for the MXU; the port calls "
              "torch.fft")
       for name in ("cfft_last", "cfft_last_split", "irfft_pow2",
                    "real_filter_pairs_split_native",
                    "real_filter_pairs_split_scrambled", "real_filter_pow2",
                    "real_filter_pow2_aligned", "real_filter_pow2_pairs",
                    "real_filter_pow2_pairs_split", "rfft_pow2",
                    "scrambled_bins", "scrambled_half_bins")},
    # the Pallas modules: their routers, plain twins and kernel wrappers
    ("ops/pallas_backbone.py", "basic_block_infer"):
        "ops/backbone_infer.py:basic_block_infer",
    ("ops/pallas_backbone.py", "basic_block_infer_pallas"):
        "ops/kernels.py:basic_block_fused",
    ("ops/pallas_backbone.py", "basic_block_infer_xla"):
        "ops/kernels.py:basic_block_fused_reference",
    ("ops/pallas_backbone.py", "fold_basic_params"):
        "ops/backbone_infer.py:fold_basic_params",
    ("ops/pallas_head.py", "conv_block_2d_head_infer"):
        "ops/head_infer.py:conv_block_2d_head_infer",
    ("ops/pallas_head.py", "fold_head_params"):
        "ops/head_infer.py:fold_head_params",
    ("ops/pallas_head.py", "head_supported"):
        "ops/head_infer.py:head_supported",
    ("ops/pallas_kernels.py", "mel_project_log"):
        "ops/kernels.py:mel_project_log",
    ("ops/pallas_kernels.py", "mel_project_log_ri"):
        "ops/kernels.py:mel_log_split",
    ("ops/pallas_kernels.py", "pv_resynth_pallas"):
        "ops/kernels.py:pv_resynth",
    ("ops/pallas_kernels.py", "resample_linear_pallas"):
        "ops/kernels.py:resample_linear",
    ("ops/pallas_kernels.py", "static_bound_exceeded"):
        (TPU, "whether a traced value is known at trace time; the port's "
              "K2 and K3 check their domain on the card"),
    ("ops/pallas_resnet.py", "fold_block_params"):
        "ops/resnet_infer.py:fold_block_params",
    ("ops/pallas_resnet.py", "resnet_block_2d_infer"):
        "ops/resnet_infer.py:resnet_block_2d_infer",
    ("ops/pallas_resnet.py", "resnet_block_2d_infer_pallas_t"):
        "ops/kernels.py:resnet_block_2d_fused",
    ("ops/pallas_resnet.py", "resnet_block_2d_infer_xla"):
        "ops/kernels.py:resnet_block_2d_fused_reference",
    ("ops/pallas_resnet1d.py", "fold_block_params_1d"):
        "ops/resnet_infer.py:fold_block_params_1d",
    ("ops/pallas_resnet1d.py", "resnet_block_1d_infer"):
        "ops/resnet_infer.py:resnet_block_1d_infer",
    ("ops/pallas_resnet1d.py", "resnet_block_1d_infer_pallas"):
        "ops/kernels.py:resnet_block_1d_fused",
    ("ops/pallas_resnet1d.py", "resnet_block_1d_infer_xla"):
        "ops/kernels.py:resnet_block_1d_fused_reference",
    ("ops/pooling.py", "max_pool_nonoverlap"):
        (TPU, "a max-pool with an elementwise VJP for the TPU's "
              "reduce_window; the port's blocks pool with torch"),
    # checkpoints: npz folds and one torch.save bundle, written durably
    ("training/checkpoints.py", "atomic_write_json"):
        "interop.py:write_durably",
    ("training/checkpoints.py", "load_resume_meta"):
        "training/checkpoints.py:load_bundle",
    ("training/checkpoints.py", "restore_raw"): "interop.py:load_fold_npz",
    ("training/checkpoints.py", "restore_state"):
        "training/checkpoints.py:load_bundle",
    ("training/checkpoints.py", "save_resume_bundle"):
        "training/checkpoints.py:save_bundle",
    ("training/checkpoints.py", "save_state"):
        "training/checkpoints.py:save_model",
    ("training/multifold.py", "make_fold_dp_mesh"):
        "training/multifold.py:make_fold_mesh",
    # optax's torch-semantics AMSGrad and Nesterov SGD: torch.optim's own
    ("training/optimizers.py", "ScaleByAmsgradTorchState"):
        "training/optimizers.py:make_optimizer",
    ("training/optimizers.py", "adam_amsgrad"):
        "training/optimizers.py:make_optimizer",
    ("training/optimizers.py", "scale_by_amsgrad_torch"):
        "training/optimizers.py:make_optimizer",
    ("training/optimizers.py", "sgd_nesterov"):
        "training/optimizers.py:make_optimizer",
    ("training/state.py", "TrainState"): "training/engine.py:Engine",
    ("training/state.py", "create_train_state"):
        "training/state.py:create_model",
    ("parallel/mesh.py", "batch_sharding"): "parallel/mesh.py:shard_batch",
    ("parallel/mesh.py", "replicate_state"):
        "parallel/mesh.py:broadcast_module",
    ("parallel/mesh.py", "replicated"):
        (TPU, "a NamedSharding with no partition; each rank of the port "
              "holds whole tensors"),
    ("models/blocks.py", "phase_conv_pool_1d"):
        (TPU, "the eval conv + pool decomposed by phase for the MXU; the "
              "port convolves, then pools"),
    ("models/blocks.py", "phase_conv_pool_2d"):
        (TPU, "the same in 2d"),
    ("models/merged_ensemble.py", "merged_infer_logits"):
        (TPU, "the folds packed into the channels to fill the TPU's 128 "
              "lanes; the port's ensemble is training/ensemble.py"),
    ("cli/common.py", "initialize_accelerator"):
        (CLI, "utils/device.py:resolve_device"),
    ("cli/common.py", "predict_ordered"):
        (CLI, "training/ensemble.py:EnsemblePredictor.predict_loader"),
    ("cli/common.py", "run_folds_parallel"):
        (CLI, "cli/common.py:run_training"),
    ("cli/predict_2d_cnn.py", "build_inference_engine"):
        "cli/predict_2d_cnn.py:build_predictor",
    ("cli/relabel_noisy_data.py", "binarize"):
        "data/folds.py:binarize_label_strings",
    ("data/dataset.py", "manifest_from_dataframe"):
        "data/dataset.py:read_manifest",
    ("data/folds.py", "MultilabelStratifiedKFold"):
        "data/folds.py:multilabel_stratified_splits",
    # the optional C++ decoder: the port's numpy reader
    ("native/__init__.py", "available"): "data/audio_io.py:read_audio",
    ("native/__init__.py", "read_wav"): "data/audio_io.py:read_wav",
    ("native/__init__.py", "read_wav_into"): "data/audio_io.py:read_audio",
    ("native/__init__.py", "resample_linear"): "data/audio_io.py:resample",
    ("native/__init__.py", "wav_info"): "data/audio_io.py:wav_length",
    **{("utils/hlo_traffic.py", name):
        (TPU, "reads the bytes of XLA's compiled HLO")
       for name in ("compiled_traffic_bytes", "entry_traffic",
                    "shape_bytes")},
}

# (file, line of the pallas_call, its function) -> (the port's wrapper in
# ops/kernels.py, its name in chip_smoke.WRAPPER_KERNEL)
KERNELS = {
    ("freesound_classification_tpu/ops/pallas_kernels.py", 63,
     "_mel_project_log_2d"): ("mel_project_log", "K1"),
    ("freesound_classification_tpu/ops/pallas_kernels.py", 198,
     "_resample_pallas"): ("resample_linear", "K2"),
    ("freesound_classification_tpu/ops/pallas_kernels.py", 481,
     "_pv_resynth"): ("pv_resynth", "K3"),
    ("freesound_classification_tpu/ops/pallas_resnet.py", 186,
     "_fused_pallas"): ("resnet_block_2d_fused", "K4/K5"),
    ("freesound_classification_tpu/ops/pallas_resnet.py", 354,
     "_fused_pallas_t"): ("resnet_block_2d_fused", "K4/K5"),
    ("freesound_classification_tpu/ops/pallas_resnet1d.py", 171,
     "_fused_pallas_1d"): ("resnet_block_1d_fused", "K6"),
    ("freesound_classification_tpu/ops/pallas_backbone.py", 191,
     "_basic_pallas_t"): ("basic_block_fused", "K7"),
    ("freesound_classification_tpu/ops/pallas_head.py", 203,
     "_head_pallas"): ("conv_head_fused", "K8"),
    ("scripts/probe_dft_context.py", 132, "fast_featurize"):
        ("mel_log_split", "K9"),
}


def _tree(path: str) -> ast.Module:
    with open(os.path.join(REPO, path)) as f:
        return ast.parse(f.read(), path)


def _defs(body) -> dict:
    return {n.name: n for n in body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}


def _public(path: str) -> set:
    return {name for name in _defs(_tree(path).body)
            if not name.startswith("_")}


def _jax_modules() -> list:
    root = os.path.join(REPO, JAX)
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root)
                  for f in files if f.endswith(".py"))


def _uncovered() -> set:
    """(module, name) of every public JAX name with no same-named function
    or class in the port module of the same path."""
    out = set()
    for rel in _jax_modules():
        port = os.path.join(PORT, rel)
        have = _public(port) if os.path.isfile(os.path.join(REPO, port)) \
            else set()
        out |= {(rel, name) for name in _public(os.path.join(JAX, rel))
                - have}
    return out


def _resolves(ref: str) -> bool:
    """Whether ``module:name`` (or ``module:Class.method``) is a function
    or class of the port."""
    module, name = ref.split(":")
    path = os.path.join(PORT, module)
    if not os.path.isfile(os.path.join(REPO, path)):
        return False
    body = _tree(path).body
    for part in name.split("."):
        node = _defs(body).get(part)
        if node is None:
            return False
        body = node.body
    return True


def test_every_uncovered_jax_name_is_in_the_table():
    missing = sorted(_uncovered() - set(COUNTERPARTS))
    assert not missing, (
        f"public JAX names with no port function or class of the same name "
        f"and no entry in COUNTERPARTS: {missing}")


def test_the_table_lists_the_87_jax_names():
    """The JAX package is frozen: the table keeps its 87 names even where
    the port later gains a function of the same name."""
    assert len(COUNTERPARTS) == 87
    assert all(name in _public(os.path.join(JAX, module))
               for module, name in COUNTERPARTS)


@pytest.mark.parametrize("entry", sorted(COUNTERPARTS),
                         ids=lambda e: f"{e[0]}:{e[1]}")
def test_each_entry_names_a_jax_name_and_its_counterpart(entry):
    module, name = entry
    assert name in _public(os.path.join(JAX, module))
    stands_for = COUNTERPARTS[entry]
    if isinstance(stands_for, str):
        assert _resolves(stands_for), f"{stands_for} is gone from the port"
        return
    kind, what = stands_for
    assert kind in (TPU, CLI)
    if kind == CLI:
        assert _resolves(what), f"{what} is gone from the port"
    else:
        assert len(what.split()) >= 3


def _pallas_sites() -> set:
    """(file, line, innermost enclosing function) of every
    ``*.pallas_call(...)`` outside the port, the tests and build outputs."""
    files = [os.path.join(JAX, rel) for rel in _jax_modules()]
    files += sorted(os.path.join("scripts", f)
                    for f in os.listdir(os.path.join(REPO, "scripts"))
                    if f.endswith(".py"))
    files += sorted(f for f in os.listdir(REPO) if f.endswith(".py"))
    sites = set()

    def visit(node, path, function):
        for child in ast.iter_child_nodes(node):
            inner = function
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                inner = child.name
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr == "pallas_call"):
                sites.add((path, child.lineno, function))
            visit(child, path, inner)

    for path in files:
        visit(_tree(path), path, None)
    return sites


def test_the_pallas_call_sites_are_the_nine_of_the_table():
    assert _pallas_sites() == set(KERNELS)
    assert len(KERNELS) == 9


def _wrapper_kernel() -> dict:
    for node in _tree("chip_smoke.py").body:
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["WRAPPER_KERNEL"]):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no WRAPPER_KERNEL")


@pytest.mark.parametrize("site", sorted(KERNELS),
                         ids=lambda s: f"{os.path.basename(s[0])}:{s[1]}")
def test_each_kernel_site_has_its_wrapper_and_smoke_entry(site):
    wrapper, name = KERNELS[site]
    assert _resolves(f"ops/kernels.py:{wrapper}")
    assert _resolves(f"ops/kernels.py:{wrapper}_reference")
    assert _wrapper_kernel().get(wrapper) == name
