"""piper-tpu-torch: the PyTorch/CUDA port of piper-tpu.

The JAX package `piper_tpu` is the reference; this package mirrors its
layout and module names (`piper_tpu_torch.models.vits.hifigan` is the
counterpart of `piper_tpu.models.vits.hifigan`) and keeps its (B, C, T)
layouts and parameter names at every public function. It imports torch,
never jax and nothing of `piper_tpu`: the jax-free modules it needs
(`onnx`, `core`, `models.vits.{hparams,synthetic}`) are its own copies.
The Pallas kernels on the main path become hand-written CUDA
kernels for Hopper (`csrc/`, bound in `ops/kernels/`); everything XLA
computed outside a kernel is plain PyTorch.

The runtime is imported lazily so that `import piper_tpu_torch` stays light.
"""

__all__ = ["PiperRuntime", "RuntimeOptions", "RunTimings"]


def __getattr__(name):
    if name in __all__:
        from piper_tpu_torch.engine import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module 'piper_tpu_torch' has no attribute {name!r}")
