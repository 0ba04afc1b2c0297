"""Entry ``vocode``: mel -> wav through the port's
``WaveNetGenerator.generate``, ``batch`` mels a call in a closed loop.

Set-up makes the weights on the device from the seed, builds the
generator (bf16 weights on the card, as it serves by default) and warms
up both sampling modes at the cell's batch.  The window runs the traffic's
calls; each request's latency is its call's, submit to return.  After the
window the served wavs are judged: every one is finite, in [-1, 1] and of
its mel's length, and a sample of the greedy ones, the longest with it,
is held to the plain reference teacher-forced over the served samples
(``reference.wavenet.greedy_gap``)."""
from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark import harness, traffic, weights, work
from benchmark.harness import Check, Context, Outcome
from benchmark.reference import wavenet as ref


@dataclass
class Served:
    request: traffic.Request
    greedy: bool
    latency: float
    wav: Optional[np.ndarray]


def port_config(conf: dict):
    from tacotron_wavenet_vocoder_korean_tpu_torch.config import from_dict
    return from_dict({k: conf[k] for k in ("audio", "wavenet", "train")
                      if k in conf})


def load_sources(params: dict) -> List[np.ndarray]:
    return [np.load(harness.repo_path(p)).astype(np.float32)
            for p in params["sources"]]


class VocodeCell:
    """The generator of a cell and the loop that serves its traffic."""

    def __init__(self, ctx: Context):
        from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
            WaveNetGenerator)
        self.ctx = ctx
        conf = ctx.config
        self.w = conf["wavenet"]
        self.hop = conf["audio"]["hop_size"]
        self.sr = conf["audio"]["sample_rate"]
        self.dtype = conf["serve_weight_dtype"]
        self.params = ctx.workload["traffic"]
        ctx.phase("imports")
        params = weights.wavenet_weights(self.w, ctx.rng_seed(1), ctx.device)
        ctx.phase("weights")
        self.generator = WaveNetGenerator(
            port_config(conf), params, device=ctx.device,
            weight_dtype=getattr(torch, self.dtype))
        del params
        self.sources = load_sources(self.params)
        ctx.phase("generator")

    def warm_up(self) -> None:
        """Both sampling modes at the cell's batch, on short mels."""
        mels = [s[:2] for s in self.sources] * self.params["batch"]
        mels = mels[:self.params["batch"]]
        for greedy in (True, False):
            self.generator.generate(mels, seed=1, deterministic=greedy)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def serve(self, window: harness.Window, np_seed: int) -> List[Served]:
        rec = self.ctx.recorder
        out: List[Served] = []
        window.open()
        for call in traffic.calls(self.params, np_seed, self.sources):
            frames = [r.size for r in call.requests]
            t0 = time.perf_counter()
            try:
                with rec.span("generate", steps=max(frames) * self.hop,
                              frames=frames):
                    wavs = self.generator.generate(
                        [r.mel for r in call.requests], seed=call.seed,
                        deterministic=call.greedy)
            except Exception:            # counted as failed, run goes on
                traceback.print_exc(file=sys.stderr)
                wavs = [None] * len(call.requests)
            latency = time.perf_counter() - t0
            out.extend(Served(r, call.greedy, latency, wav)
                       for r, wav in zip(call.requests, wavs))
            if window.due():
                break
        window.close()
        return out

    def free(self) -> None:
        self.generator = None
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- judging ---------------------------------------------------------
    def bad(self, s: Served) -> bool:
        if s.wav is None:
            return True
        wav = np.asarray(s.wav)
        return (wav.shape != (s.request.size * self.hop,)
                or not np.all(np.isfinite(wav))
                or float(np.abs(wav).max()) > 1.0)

    def sample_greedy(self, served: List[Served], n: int,
                      np_seed: int) -> List[Served]:
        """Up to ``n`` greedy answers drawn from the seed, the longest
        first among them."""
        greedy = [s for s in served if s.greedy and not self.bad(s)]
        if not greedy:
            return []
        longest = max(greedy, key=lambda s: s.request.size)
        rest = [s for s in greedy if s is not longest]
        rng = np.random.default_rng(np_seed)
        pick = rng.permutation(len(rest))[:max(0, n - 1)]
        return [longest] + [rest[i] for i in sorted(pick)]

    @torch.no_grad()
    def reference_outputs(self, s: Served, params, rnd=ref.identity
                          ) -> torch.Tensor:
        """The network's outputs [T, C] teacher-forced over the served
        samples of ``s`` (step t sees the samples before t)."""
        dev = self.ctx.device
        served = torch.from_numpy(np.asarray(s.wav, np.float32)).to(dev)
        mel = torch.from_numpy(s.request.mel).to(dev)[None]
        lc = ref.upsample(mel, params, self.w, rnd)
        x = torch.cat([served.new_zeros(1), served[:-1]])[None]
        return ref.forward(params, self.w, x, lc, causal=True, rnd=rnd)[0]

    def gaps(self, sample: List[Served], control: bool = False) -> float:
        """The widest greedy gap over ``sample``: the program's served
        samples, or (``control``) the samples that the reference in fp8
        puts first at the same positions."""
        params = weights.wavenet_weights(self.w, self.ctx.rng_seed(1),
                                         self.ctx.device)
        worst = 0.0
        with harness.float32_products():
            for s in sample:
                raw = self.reference_outputs(s, params)
                if control:
                    low = self.reference_outputs(s, params, ref.fp8)
                    x = ref.greedy_pick(low)
                else:
                    x = torch.from_numpy(np.asarray(s.wav, np.float32)).to(
                        raw.device)
                worst = max(worst, float(ref.greedy_gap(raw, x).max()))
        return worst


def trace_info(cell: VocodeCell, served: List[Served]) -> dict:
    """What the per-layer readers need of the traced calls: the work of
    the requests they completed, counted from the configuration."""
    done = [s for s in served if s.wav is not None]
    frames = [s.request.size for s in done]
    flops = work.mel_to_wav_flops(cell.w, frames, cell.hop)
    return {"serve_dtype": cell.dtype,
            "vocoder_flops": flops,
            "vocoder_bytes": work.mel_to_wav_bytes(cell.w, frames, cell.hop,
                                                   cell.dtype),
            "served_flops": flops,
            "generate_steps": sum(sp.attrs["steps"] for sp in
                                  cell.ctx.recorder.of("generate"))}


def run(ctx: Context) -> Outcome:
    cell = VocodeCell(ctx)
    cell.warm_up()
    window = ctx.window()
    ctx.end_setup()
    served: List[Served] = []

    def body():
        served.extend(cell.serve(window, ctx.np_seed(2)))

    chrome = harness.traced_window(ctx, body)
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    cell.free()

    check = ctx.workload["check"]
    bad = [s for s in served if cell.bad(s)]
    sample = cell.sample_greedy(served, check["greedy_requests"],
                                ctx.np_seed(3))
    # no greedy answer to judge: the gap is unknown, so it fails
    gap = cell.gaps(sample) if sample else float("inf")
    checks = [Check("bad_answers", float(len(bad)), 0.0),
              Check("greedy_gap", gap, check["greedy_gap"])]
    out = Outcome(attempted=len(served),
                  failed=sum(s.wav is None for s in served), checks=checks,
                  memory_peak_bytes=peak)
    audio = sum(len(s.wav) for s in served if s.wav is not None) / cell.sr
    out.e2e = {"audio_s_per_s": audio / window.length,
               "request_p95_s": harness.percentile(
                   [s.latency for s in served], 95)}
    if chrome is not None:
        info = trace_info(cell, served)
        info["window_s"] = window.length
        out.trace = harness.parse_trace(chrome, ctx.recorder, info)
    return out
