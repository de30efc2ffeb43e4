"""What a multi-speaker voice's speaker conditioning costs the card.

The bench's `multispeaker` batch (the synthetic N-speaker medium voice, gin
512, the bench's mixed tiers, B rows of the fixture phrase repeated
`--factor` times, speaker ids 0..B-1 mod N): one `synthesize_batch` under
torch.profiler (`tools/timing.py::profile_call`: device kernels and busy
ms), then the conditioning's own device work alone at that batch's shapes,
with the tier each piece runs at in the batch: the speaker vector (the
emb_g row lookup for ids, the true-fp32 weights @ emb_g product for mixes),
the 1x1 convs of g into the duration predictor, the flows and HiFi-GAN
(`*.cond.weight`, `*.cond_layer.weight`), and the two broadcast adds of g
onto the duration predictor's and HiFi-GAN's inputs. The flows' WaveNet
adds its g slice in the same kernel whether or not the voice has speakers,
so nothing more is counted there. One JSON line, with the card's name and
power limit. It needs the card and has no other path.

    python -m piper_tpu_torch.tools.speaker_probe [--speakers 904] [--batch 32]
        [--factor 8] [--reps 10]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--speakers", type=int, default=904)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--factor", type=int, default=8)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("speaker_probe: no CUDA device (it measures the card)")
    from piper_tpu_torch import bench
    from piper_tpu_torch.core.test_vector import FIXTURE_PHONEME_IDS
    from piper_tpu_torch.models.vits.model import speaker_embedding
    from piper_tpu_torch.ops.conv import conv1d
    from piper_tpu_torch.ops.kernels.precision import tier_scope
    from piper_tpu_torch.tools.timing import device_ms, profile_call

    rt = bench.get_runtime(bench._parser().parse_args([]), n_speakers=args.speakers, gin=512)
    hp, params, dev, o = rt.hparams, rt.params, rt.device, rt.options
    batch = [(FIXTURE_PHONEME_IDS * args.factor)[:4096]] * args.batch
    sids = [i % args.speakers for i in range(args.batch)]
    rt.synthesize_batch(batch, speaker_ids=sids)
    t = rt.last_run_timings
    symbol, counters = bench._vocoder_kernels(rt)
    whole = profile_call(lambda: rt.synthesize_batch(batch, speaker_ids=sids), symbol, counters)

    vp = o.vocoder_precision
    dec_tier = vp[0] if isinstance(vp, (tuple, list)) else vp
    convs = [(name[: -len(".weight")], o.flow_precision if name.startswith("flow.") else
              dec_tier if name.startswith("dec.") else None)
             for name in sorted(params) if name.endswith(("cond.weight", "cond_layer.weight"))]
    dp_in = torch.zeros(args.batch, params["dp.cond.weight"].shape[0], t.phoneme_bucket,
                        device=dev)
    dec_in = torch.zeros(args.batch, params["dec.cond.weight"].shape[0], t.frame_bucket,
                         device=dev)
    ids = torch.tensor(sids, device=dev)
    mix = torch.zeros(args.batch, args.speakers, device=dev)
    mix[torch.arange(args.batch), ids] = 0.6
    mix[:, 0] += 0.4

    def conditioning(sid):
        with rt._device_work():
            g = speaker_embedding(params, hp, sid)
            for prefix, tier in convs:
                with tier_scope(tier, dev):
                    c = conv1d(g, params[f"{prefix}.weight"], params[f"{prefix}.bias"])
                    if prefix == "dp.cond":
                        c = dp_in + c
                    elif prefix == "dec.cond":
                        c = dec_in + c

    row = {"nvidia_smi": bench._device_info(torch, "cuda")["nvidia_smi"],
           "speakers": args.speakers, "batch": args.batch, "factor": args.factor,
           "phoneme_bucket": t.phoneme_bucket, "frame_bucket": t.frame_bucket,
           "frames": t.frames, "batch_device_kernels": whole["device_kernels"],
           "batch_device_busy_ms": whole["device_busy_ms"],
           "cond_convs": [p for p, _ in convs],
           "conditioning_ids_ms": device_ms(lambda: conditioning(ids), reps=args.reps),
           "conditioning_mix_ms": device_ms(lambda: conditioning(mix), reps=args.reps)}
    row["conditioning_ids_share"] = row["conditioning_ids_ms"] / row["batch_device_busy_ms"]
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
