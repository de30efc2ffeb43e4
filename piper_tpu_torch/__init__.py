"""piper-tpu-torch: the PyTorch/CUDA port of piper-tpu.

The JAX package `piper_tpu` is the reference; this package mirrors its
layout and module names (`piper_tpu_torch.models.vits.hifigan` is the
counterpart of `piper_tpu.models.vits.hifigan`) and keeps its (B, C, T)
layouts and parameter names at every public function. It imports torch,
never jax and nothing of `piper_tpu`: the jax-free modules it needs
(`onnx`, `core`, `models.vits.{hparams,synthetic}`, `client`, `version`)
are its own copies. The Pallas kernels on the main path become hand-written
CUDA kernels for Hopper (`csrc/`, bound in `ops/kernels/`); everything XLA
computed outside a kernel is plain PyTorch.

Public API surface, the JAX package's names (plus RunTimings):
    - VoiceConfig, AudioFormat/AudioChunk, PhonemeAlignment
    - TestVector/TestSummary, VoiceIndex/VoiceManager
    - PiperRuntime, RuntimeOptions, RunTimings
    - ServingPipeline, BatchingServer, VoiceServer
    - PiperClient, PiperStreamingClient, PiperClientError
    - __version__

Every name loads on first access, so `import piper_tpu_torch` stays light.
"""

__all__ = [
    "VoiceConfig",
    "AudioFormat",
    "AudioChunk",
    "PhonemeAlignment",
    "TestVector",
    "TestSummary",
    "VoiceIndex",
    "VoiceManager",
    "PiperRuntime",
    "RuntimeOptions",
    "RunTimings",
    "ServingPipeline",
    "BatchingServer",
    "VoiceServer",
    "PiperClient",
    "PiperStreamingClient",
    "PiperClientError",
    "__version__",
]

_LAZY = {
    "VoiceConfig": ("piper_tpu_torch.core.config", "VoiceConfig"),
    "AudioFormat": ("piper_tpu_torch.core.audio", "AudioFormat"),
    "AudioChunk": ("piper_tpu_torch.core.audio", "AudioChunk"),
    "PhonemeAlignment": ("piper_tpu_torch.core.alignment", "PhonemeAlignment"),
    "TestVector": ("piper_tpu_torch.core.test_vector", "TestVector"),
    "TestSummary": ("piper_tpu_torch.core.test_vector", "TestSummary"),
    "VoiceIndex": ("piper_tpu_torch.core.voices", "VoiceIndex"),
    "VoiceManager": ("piper_tpu_torch.core.voices", "VoiceManager"),
    "PiperRuntime": ("piper_tpu_torch.engine.runtime", "PiperRuntime"),
    "RuntimeOptions": ("piper_tpu_torch.engine.runtime", "RuntimeOptions"),
    "RunTimings": ("piper_tpu_torch.engine.runtime", "RunTimings"),
    "ServingPipeline": ("piper_tpu_torch.engine.pipeline", "ServingPipeline"),
    "BatchingServer": ("piper_tpu_torch.engine.batcher", "BatchingServer"),
    "MultiVoiceBatchingServer": ("piper_tpu_torch.engine.batcher", "MultiVoiceBatchingServer"),
    "VoiceServer": ("piper_tpu_torch.engine.server", "VoiceServer"),
    "PiperClient": ("piper_tpu_torch.client", "PiperClient"),
    "PiperStreamingClient": ("piper_tpu_torch.client", "PiperStreamingClient"),
    "PiperClientError": ("piper_tpu_torch.client", "PiperClientError"),
    "__version__": ("piper_tpu_torch.version", "__version__"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'piper_tpu_torch' has no attribute {name!r}")
