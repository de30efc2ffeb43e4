"""Multi-voice serving: several voices resident in one process (the port's
copy of piper_tpu.engine.server, on the card unless asked for the CPU).

The reference loads one voice per runtime instance and its streaming wrapper
even spawns a fresh runtime per request (PiperMetalRuntime.swift:95-137).
Here voices load once and stay device-resident; an optional LRU cap bounds
the device memory their weights take (`PiperRuntime.hbm_bytes()` per voice).
Every runtime goes to the server's `device`: "cuda" by default, which
raises where there is no card; the CPU only when the caller passes
device="cpu".
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from piper_tpu_torch.core.audio import AudioChunk
from piper_tpu_torch.core.voices import VoiceManager
from piper_tpu_torch.engine.pipeline import ServingPipeline
from piper_tpu_torch.engine.runtime import PiperRuntime, RuntimeOptions


class VoiceServer:
    def __init__(
        self,
        options: Optional[RuntimeOptions] = None,
        max_voices: Optional[int] = None,
        manager: Optional[VoiceManager] = None,
        *,
        device: str = "cuda",
    ):
        self.options = options
        self.device = device
        self.max_voices = max_voices
        self.manager = manager or VoiceManager()
        self._voices: "OrderedDict[str, PiperRuntime]" = OrderedDict()
        self._pipelines: Dict[str, ServingPipeline] = {}

    # -- voice management ----------------------------------------------------

    def load(
        self,
        voice: Union[str, Path],
        config_path: Union[str, Path, None] = None,
        key: Optional[str] = None,
    ) -> str:
        """Load a voice by id (downloads if needed) or by checkpoint path.

        Returns the key under which it is served (the id or file stem)."""
        voice = str(voice)
        if key is None:
            key = Path(voice).stem if voice.endswith(".onnx") else voice
        if key in self._voices:
            self._voices.move_to_end(key)
            return key
        if voice.endswith(".onnx"):
            rt = PiperRuntime(voice, config_path, self.options, device=self.device)
        else:
            rt = PiperRuntime.load_voice(voice, self.options, self.manager,
                                         device=self.device)
        self._voices[key] = rt
        self._evict()
        return key

    def _evict(self) -> None:
        while self.max_voices is not None and len(self._voices) > self.max_voices:
            evicted_key, _ = self._voices.popitem(last=False)
            pipe = self._pipelines.pop(evicted_key, None)
            if pipe is not None:
                pipe.close()

    def runtime(self, key: str) -> PiperRuntime:
        if key not in self._voices:
            self.load(key)
        self._voices.move_to_end(key)
        return self._voices[key]

    @property
    def loaded_voices(self) -> List[str]:
        return list(self._voices)

    # -- synthesis -----------------------------------------------------------

    def synthesize(self, voice: str, phoneme_ids: Sequence[int], **kwargs) -> np.ndarray:
        return self.runtime(voice).synthesize(phoneme_ids, **kwargs)

    def synthesize_batch(self, voice: str, batches, **kwargs) -> List[np.ndarray]:
        return self.runtime(voice).synthesize_batch(batches, **kwargs)

    def synthesize_stream(self, voice: str, phoneme_ids, **kwargs) -> Iterator[AudioChunk]:
        return self.runtime(voice).synthesize_stream(phoneme_ids, **kwargs)

    def pipeline(self, voice: str, **kwargs) -> ServingPipeline:
        """A shared async pipeline for the given voice."""
        if voice not in self._pipelines:
            self._pipelines[voice] = ServingPipeline(self.runtime(voice), **kwargs)
        return self._pipelines[voice]

    def batching_server(self, voices: Sequence[str], **kwargs):
        """A continuous batcher across the given voices (loaded on demand):
        one worker thread multiplexes every voice's bucketed queues onto the
        device (see MultiVoiceBatchingServer). The caller owns closing it."""
        from piper_tpu_torch.engine.batcher import MultiVoiceBatchingServer

        return MultiVoiceBatchingServer(
            {v: self.runtime(v) for v in voices}, **kwargs)

    def close(self) -> None:
        for pipe in self._pipelines.values():
            pipe.close()
        self._pipelines.clear()
        self._voices.clear()

    def __enter__(self) -> "VoiceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
