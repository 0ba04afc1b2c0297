"""Tacotron-1 free-run inference (counterpart of the JAX package's
``models/tacotron.py``: ``Tacotron`` with ``train=False, free_run=True``).

text ids -> embedding (PAD row zeroed at apply time) -> encoder prenet ->
CBHG (speaker-conditioned) -> memory mask, zeroed padding, ``memory_layer``
-> a decoder loop of a static ``max_iters`` steps -> mel [B, T_dec*r, M]
-> post-net CBHG -> ``linear_projection`` [B, T_dec*r, num_freq].

The decoder loop is an explicit Python loop over ``DecoderStep`` (the JAX
package's ``_ScanDecoderStep``); it holds nothing back on the host, so the
device queue stays full.  Mixed precision (``compute_dtype: bfloat16``)
follows flax: float32 parameters cast to bf16 per module with their
inputs; the attention math, the context and the returned outputs are
float32.  Decoder-prenet dropout is live when the config asks for it and a
``torch.Generator`` is passed (the JAX model gates it on a dropout rng), or
when keep-masks are given.

Multi-speaker conditioning is the ``deepvoice`` mode (soft-sign speaker
projections into the encoder's residual and every recurrent initial
state).  Teacher forcing, scheduled sampling and the losses belong to
training, which is not ported yet.
"""
from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AudioConfig, TacotronConfig
from .attention import make_attention
from .modules import CBHG, FusedGRUCell, Prenet, compute_dtype, dense


class DecoderCarry(NamedTuple):
    attn_cell: torch.Tensor                # attention GRU state  [B, A]
    context: torch.Tensor                  # attention context    [B, E]
    attn_state: torch.Tensor               # mechanism state      [B, T_in]
    dec_cells: Tuple[torch.Tensor, ...]    # residual GRU states  [B, D]
    prev_frame: torch.Tensor               # last emitted frame   [B, M]


class Encoded(NamedTuple):
    """What the decoder reads from the encoder."""
    keys: torch.Tensor                     # [B, T_in, attention_size] f32
    values: torch.Tensor                   # [B, T_in, E], padding zeroed
    mask: torch.Tensor                     # [B, T_in] bool
    init_states: Optional[Dict[str, object]]


class DecoderStep(nn.Module):
    """One decoder step: prenet -> attention GRU on [prenet, context] ->
    mechanism (-> manual alignments where asked) -> float32 context ->
    ``decoder_input_projection`` -> residual GRUs -> ``frame_projection``;
    the block's last frame feeds the next step."""

    def __init__(self, cfg: TacotronConfig, num_mels: int, enc_dim: int,
                 dtype=None):
        super().__init__()
        self.dtype = dtype
        self.num_mels = num_mels
        self.dec_layer_num = cfg.dec_layer_num
        self.decoder_prenet = Prenet(num_mels, cfg.dec_prenet_sizes,
                                     cfg.dropout_prob, dtype)
        self.attention_gru = FusedGRUCell(
            cfg.dec_prenet_sizes[-1] + enc_dim, cfg.attention_state_size,
            dtype)
        self.attention = make_attention(
            cfg.attention_type, cfg.attention_state_size, cfg.attention_size)
        self.decoder_input_projection = nn.Linear(
            cfg.attention_state_size + enc_dim, cfg.dec_rnn_size)
        for i in range(cfg.dec_layer_num):
            self.add_module(f"decoder_gru_{i + 1}", FusedGRUCell(
                cfg.dec_rnn_size, cfg.dec_rnn_size, dtype))
        self.frame_projection = nn.Linear(
            cfg.dec_rnn_size, cfg.reduction_factor * num_mels)

    def forward(self, carry: DecoderCarry, keys, values_f32, mask,
                score_vector, prenet_scales=None, manual_alignment=None
                ) -> Tuple[DecoderCarry, torch.Tensor, torch.Tensor]:
        dt = compute_dtype(self.dtype)
        x = self.decoder_prenet(carry.prev_frame, prenet_scales)
        attn_cell = self.attention_gru(
            carry.attn_cell, torch.cat([x, carry.context], dim=-1))
        alignments, next_attn_state = self.attention(
            attn_cell, carry.attn_state, keys, mask, score_vector)
        if manual_alignment is not None:
            alignments = manual_alignment
        context = torch.bmm(alignments[:, None, :], values_f32)[:, 0].to(dt)
        h = dense(self.decoder_input_projection,
                  torch.cat([attn_cell, context], dim=-1), self.dtype)
        dec_cells = []
        for i in range(self.dec_layer_num):
            cell = getattr(self, f"decoder_gru_{i + 1}")(carry.dec_cells[i], h)
            h = h + cell
            dec_cells.append(cell)
        frames = dense(self.frame_projection, h, self.dtype)
        new_carry = DecoderCarry(attn_cell, context, next_attn_state,
                                 tuple(dec_cells),
                                 frames[:, -self.num_mels:])
        return new_carry, frames, alignments

    def cast_for_loop(self) -> "DecoderStep":
        """This step with the bf16 modules' parameters cast once, for the
        loop: the same numbers the per-call cast gives, without a cast
        kernel per weight per step.  The mechanism stays float32."""
        if compute_dtype(self.dtype) == torch.float32:
            return self
        step = copy.deepcopy(self)
        for name, child in step.named_children():
            if name != "attention":
                child.to(self.dtype)
        return step


class Decoder(nn.Module):
    """The free-running loop over ``step``: [B, T_dec*r, M] frames (in the
    compute type) and [B, T_in, T_dec] float32 alignments."""

    def __init__(self, cfg: TacotronConfig, num_mels: int, enc_dim: int,
                 dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.num_mels = num_mels
        self.step = DecoderStep(cfg, num_mels, enc_dim, dtype)

    def initial_carry(self, enc: Encoded) -> DecoderCarry:
        cfg = self.cfg
        dt = compute_dtype(self.dtype)
        B, T_in, E = enc.values.shape
        dev = enc.values.device
        if enc.init_states is not None:
            attn_cell = enc.init_states["attention_rnn_init_state"].to(dt)
            dec_cells = tuple(s.to(dt) for s in
                              enc.init_states["decoder_rnn_init_states"])
        else:
            attn_cell = torch.zeros(B, cfg.attention_state_size, dtype=dt,
                                    device=dev)
            dec_cells = tuple(torch.zeros(B, cfg.dec_rnn_size, dtype=dt,
                                          device=dev)
                              for _ in range(cfg.dec_layer_num))
        return DecoderCarry(
            attn_cell=attn_cell,
            context=torch.zeros(B, E, dtype=dt, device=dev),
            attn_state=self.step.attention.init_state(B, T_in, dev),
            dec_cells=dec_cells,
            prev_frame=torch.zeros(B, self.num_mels, dtype=dt, device=dev))

    def forward(self, enc: Encoded, max_steps: int,
                prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                manual_alignments: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``prenet_masks``: one keep-mask per prenet layer, [T_dec, B,
        size] (bool), or None for no dropout.  ``manual_alignments``:
        [B, T_dec, T_in] injected in place of the computed alignments (the
        mechanism's own state still advances), or None."""
        step = self.step.cast_for_loop()
        carry = self.initial_carry(enc)
        values_f32 = enc.values.float()
        score_vector = step.attention.score_vector()
        scales = (None if prenet_masks is None
                  else step.decoder_prenet.scales_from_masks(prenet_masks))
        frames, alignments = [], []
        for t in range(max_steps):
            carry, f, a = step(
                carry, enc.keys, values_f32, enc.mask, score_vector,
                None if scales is None else [s[t] for s in scales],
                None if manual_alignments is None
                else manual_alignments[:, t])
            frames.append(f)
            alignments.append(a)
        B = enc.values.shape[0]
        mel = torch.stack(frames, dim=1).reshape(
            B, max_steps * self.cfg.reduction_factor, self.num_mels)
        return mel, torch.stack(alignments, dim=2)


class Tacotron(nn.Module):
    """text ids -> {mel_outputs, linear_outputs, alignments}, float32."""

    def __init__(self, cfg: TacotronConfig, audio: AudioConfig,
                 vocab_size: int = 80):
        super().__init__()
        self.cfg = cfg
        self.num_mels = audio.num_mels
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else None)
        dt = self.dtype
        self.char_embedding = nn.Parameter(
            torch.randn(vocab_size, cfg.embedding_size) * 0.5)
        self.deepvoice = cfg.num_speakers > 1
        if self.deepvoice:
            if cfg.model_type != "deepvoice":
                raise NotImplementedError(
                    f"model_type {cfg.model_type!r} with several speakers is "
                    "not ported yet; only 'deepvoice' is")
            S = cfg.speaker_embedding_size
            self.speaker_embedding = nn.Parameter(
                torch.randn(cfg.num_speakers, S) * 0.5)
            self.sp_before_highway = nn.Linear(S, cfg.enc_prenet_sizes[-1])
            self.sp_encoder_rnn_init = nn.Linear(S, 2 * cfg.enc_rnn_size)
            self.sp_attention_rnn_init = nn.Linear(S, cfg.attention_state_size)
            for i in range(cfg.dec_layer_num):
                self.add_module(f"sp_decoder_rnn_init_{i + 1}",
                                nn.Linear(S, cfg.dec_rnn_size))
        self.encoder_prenet = Prenet(cfg.embedding_size, cfg.enc_prenet_sizes,
                                     cfg.dropout_prob, dt)
        self.encoder_cbhg = CBHG(
            cfg.enc_prenet_sizes[-1], cfg.enc_bank_size,
            cfg.enc_bank_channel_size, cfg.enc_maxpool_width,
            cfg.enc_highway_depth, cfg.enc_rnn_size, cfg.enc_proj_sizes,
            cfg.enc_proj_width, dt)
        enc_dim = 2 * cfg.enc_rnn_size
        self.memory_layer = nn.Linear(enc_dim, cfg.attention_size, bias=False)
        self.decoder = Decoder(cfg, audio.num_mels, enc_dim, dt)
        self.post_cbhg = CBHG(
            audio.num_mels, cfg.post_bank_size, cfg.post_bank_channel_size,
            cfg.post_maxpool_width, cfg.post_highway_depth, cfg.post_rnn_size,
            cfg.post_proj_sizes, cfg.post_proj_width, dt)
        self.linear_projection = nn.Linear(2 * cfg.post_rnn_size,
                                           audio.num_freq)

    def encode(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
               speaker_id: Optional[torch.Tensor] = None) -> Encoded:
        """inputs [B, T_in] ids, input_lengths [B] (EOS included),
        speaker_id [B] (valid, non-negative ids: the caller checks them)."""
        cfg = self.cfg
        table = torch.cat([torch.zeros_like(self.char_embedding[:1]),
                           self.char_embedding[1:]])   # PAD row zeroed
        char_embedded = table[inputs]
        before_highway = enc_init = init_states = None
        if self.deepvoice:
            spk = self.speaker_embedding[speaker_id]

            def deep_dense(layer):
                return F.softsign(dense(layer, spk))
            before_highway = deep_dense(self.sp_before_highway)
            enc_init = deep_dense(self.sp_encoder_rnn_init)
            init_states = {
                "attention_rnn_init_state":
                    deep_dense(self.sp_attention_rnn_init),
                "decoder_rnn_init_states": [
                    deep_dense(getattr(self, f"sp_decoder_rnn_init_{i + 1}"))
                    for i in range(cfg.dec_layer_num)],
            }
        prenet_out = self.encoder_prenet(char_embedded)
        encoder_outputs = self.encoder_cbhg(prenet_out, input_lengths,
                                            before_highway, enc_init)
        T_in = inputs.shape[1]
        mask = (torch.arange(T_in, device=inputs.device)[None, :]
                < input_lengths[:, None])
        values = encoder_outputs * mask[..., None]
        keys = dense(self.memory_layer, values)           # float32
        return Encoded(keys, values, mask, init_states)

    def postnet(self, mel: torch.Tensor) -> torch.Tensor:
        """mel [B, T, M] (compute type) -> linear [B, T, num_freq]."""
        return dense(self.linear_projection, self.post_cbhg(mel), self.dtype)

    def draw_prenet_masks(self, max_iters: int, batch: int,
                          generator: torch.Generator) -> List[torch.Tensor]:
        """Decoder-prenet keep-masks for a whole decode, [max_iters, B,
        size] per layer, drawn from ``generator`` on its device."""
        return self.decoder.step.decoder_prenet.draw_masks(
            (max_iters, batch), generator, generator.device)

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                speaker_id: Optional[torch.Tensor] = None,
                max_iters: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                manual_alignments: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Free-run decode over a static ``max_iters`` (default the
        config's).  Prenet dropout: ``prenet_masks`` if given, else masks
        drawn from ``generator`` when the config keeps dropout on at
        inference, else none."""
        max_iters = max_iters or self.cfg.max_iters
        enc = self.encode(inputs, input_lengths, speaker_id)
        if (prenet_masks is None and generator is not None
                and self.cfg.dec_prenet_dropout_inference):
            prenet_masks = self.draw_prenet_masks(max_iters, inputs.shape[0],
                                                  generator)
        mel, alignments = self.decoder(enc, max_iters, prenet_masks,
                                       manual_alignments)
        linear = self.postnet(mel)
        return {"mel_outputs": mel.float(),
                "linear_outputs": linear.float(),
                "alignments": alignments.float()}
