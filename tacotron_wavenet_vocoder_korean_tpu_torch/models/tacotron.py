"""Tacotron-1, its loss and its schedules (counterpart of the JAX
package's ``models/tacotron.py``).

text ids -> embedding (PAD row zeroed at apply time) -> encoder prenet ->
CBHG (speaker-conditioned) -> memory mask, zeroed padding, ``memory_layer``
-> a decoder loop -> mel [B, T_dec*r, M] -> post-net CBHG ->
``linear_projection`` [B, T_dec*r, num_freq].  Without targets the decoder
runs free for a static ``max_iters`` steps; with ``mel_targets`` [B, T_out,
M] it runs T_out / r steps, teacher-forced (step t is fed block t-1's last
target frame, step 0 the <GO> zero frame), or free-running against them
(``free_run=True``, the evaluation), or with scheduled sampling
(``use_teacher``: per step and example, the target frame or the model's
own last frame).

The decoder loop is an explicit Python loop over ``DecoderStep`` (the JAX
package's ``_ScanDecoderStep``); it holds nothing back on the host, so the
device queue stays full.  Mixed precision (``compute_dtype: bfloat16``)
follows flax: float32 parameters cast to bf16 per module with their
inputs; the attention math, the context and the returned outputs are
float32.  Decoder-prenet dropout is live when the config asks for it and a
``torch.Generator`` is passed (the JAX model gates it on a dropout rng), or
when keep-masks are given.

``train=True`` is flax's training mode: batch norm from the batch's
statistics (the new running statistics come back through ``bn_updates``)
and dropout in both prenets, from keep-masks the caller passes or draws
from a ``torch.Generator``.  Under autograd the decoder casts its bf16
weights per step, so their gradients accumulate in float32 as JAX's scan
accumulates them; serving casts them once (``cast_for_loop``).

The mechanism is any of the JAX table's nine (``models/attention.py``);
what it can hoist out of the loop (``loop_constants``) is computed once
per decode.  With several speakers, conditioning is the ``deepvoice``
mode (soft-sign speaker projections into the encoder's residual and
every recurrent initial state) or the ``simple`` one (the speaker's
embedding, in the compute type, concatenated into the attention GRU's
input, the decoder's input projection and, ahead of the post-net's
output, the linear projection); with one speaker nothing conditions.
"""
from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import AudioConfig, TacotronConfig
from .attention import make_attention
from .modules import (BNUpdates, CBHG, FusedGRUCell, Prenet,
                      compute_dtype, dense)


class DecoderCarry(NamedTuple):
    attn_cell: torch.Tensor                # attention GRU state  [B, A]
    context: torch.Tensor                  # attention context    [B, E]
    attn_state: torch.Tensor               # mechanism state      [B, T_in]
                                           # (GMM: kappa [B, U])
    dec_cells: Tuple[torch.Tensor, ...]    # residual GRU states  [B, D]
    prev_frame: torch.Tensor               # last emitted frame   [B, M]


class Encoded(NamedTuple):
    """What the decoder reads from the encoder."""
    keys: torch.Tensor                     # [B, T_in, attention_size] f32
    values: torch.Tensor                   # [B, T_in, E], padding zeroed
    mask: torch.Tensor                     # [B, T_in] bool
    init_states: Optional[Dict[str, object]]   # deepvoice
    speaker_embed: Optional[torch.Tensor]  # simple: [B, S] f32


class DecoderStep(nn.Module):
    """One decoder step: prenet -> attention GRU on [prenet, (speaker,)
    context] -> mechanism (-> manual alignments where asked) -> float32
    context -> ``decoder_input_projection`` of [GRU output, context,
    (speaker)] -> residual GRUs -> ``frame_projection``; the block's last
    frame feeds the next step.  ``speaker_dim``: the ``simple`` mode's
    embedding width (0 without it)."""

    def __init__(self, cfg: TacotronConfig, num_mels: int, enc_dim: int,
                 dtype=None, speaker_dim: int = 0):
        super().__init__()
        self.dtype = dtype
        self.num_mels = num_mels
        self.dec_layer_num = cfg.dec_layer_num
        self.decoder_prenet = Prenet(num_mels, cfg.dec_prenet_sizes,
                                     cfg.dropout_prob, dtype)
        self.attention_gru = FusedGRUCell(
            cfg.dec_prenet_sizes[-1] + speaker_dim + enc_dim,
            cfg.attention_state_size, dtype)
        self.attention = make_attention(
            cfg.attention_type, cfg.attention_state_size, cfg.attention_size)
        self.decoder_input_projection = nn.Linear(
            cfg.attention_state_size + enc_dim + speaker_dim,
            cfg.dec_rnn_size)
        for i in range(cfg.dec_layer_num):
            self.add_module(f"decoder_gru_{i + 1}", FusedGRUCell(
                cfg.dec_rnn_size, cfg.dec_rnn_size, dtype))
        self.frame_projection = nn.Linear(
            cfg.dec_rnn_size, cfg.reduction_factor * num_mels)

    def forward(self, carry: DecoderCarry, keys, values_f32, mask,
                consts, prenet_scales=None, manual_alignment=None,
                teacher_frame=None, take_teacher=None, speaker=None
                ) -> Tuple[DecoderCarry, torch.Tensor, torch.Tensor]:
        """``consts``: the mechanism's ``loop_constants(keys)``.
        ``teacher_frame`` [B, M]: fed in place of the last emitted
        frame, where ``take_teacher`` [B] (bool) is set, or everywhere
        when it is None.  ``speaker`` [B, S]: the ``simple`` mode's
        embedding in the compute type, or None."""
        dt = compute_dtype(self.dtype)
        frame_in = carry.prev_frame
        if teacher_frame is not None:
            frame_in = (teacher_frame if take_teacher is None else
                        torch.where(take_teacher[:, None], teacher_frame,
                                    carry.prev_frame))
        x = self.decoder_prenet(frame_in, prenet_scales)
        spk = [] if speaker is None else [speaker]
        attn_cell = self.attention_gru(
            carry.attn_cell, torch.cat([x, *spk, carry.context], dim=-1))
        alignments, next_attn_state = self.attention(
            attn_cell, carry.attn_state, keys, mask, consts)
        if manual_alignment is not None:
            alignments = manual_alignment
        context = torch.bmm(alignments[:, None, :], values_f32)[:, 0].to(dt)
        h = dense(self.decoder_input_projection,
                  torch.cat([attn_cell, context, *spk], dim=-1), self.dtype)
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
                 dtype=None, speaker_dim: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.num_mels = num_mels
        self.step = DecoderStep(cfg, num_mels, enc_dim, dtype, speaker_dim)

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
                manual_alignments: Optional[torch.Tensor] = None,
                teacher: Optional[torch.Tensor] = None,
                use_teacher: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``prenet_masks``: one keep-mask per prenet layer, [T_dec, B,
        size] (bool), or None for no dropout.  ``manual_alignments``:
        [B, T_dec, T_in] injected in place of the computed alignments (the
        mechanism's own state still advances), or None.  ``teacher``:
        [T_dec, B, M] frames fed at each step (None: free run), where
        ``use_teacher`` [T_dec, B] (bool) is set, or everywhere when it is
        None."""
        # Under autograd the per-call casts stay in the graph; each step's
        # weight gradient is cast back to float32 before it accumulates.
        step = (self.step if torch.is_grad_enabled()
                else self.step.cast_for_loop())
        dt = compute_dtype(self.dtype)
        carry = self.initial_carry(enc)
        values_f32 = enc.values.float()
        consts = step.attention.loop_constants(enc.keys)
        speaker = (None if enc.speaker_embed is None
                   else enc.speaker_embed.to(dt))
        scales = (None if prenet_masks is None
                  else step.decoder_prenet.scales_from_masks(prenet_masks))
        if teacher is not None:
            teacher = teacher.to(dt)
        frames, alignments = [], []
        for t in range(max_steps):
            carry, f, a = step(
                carry, enc.keys, values_f32, enc.mask, consts,
                None if scales is None else [s[t] for s in scales],
                None if manual_alignments is None
                else manual_alignments[:, t],
                None if teacher is None else teacher[t],
                None if use_teacher is None else use_teacher[t], speaker)
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
        # The speaker mode: None with one speaker, else the model_type.
        self.speaker_mode = None
        S = cfg.speaker_embedding_size
        if cfg.num_speakers > 1:
            if cfg.model_type not in ("deepvoice", "simple"):
                raise ValueError(f"bad model_type {cfg.model_type!r} for "
                                 "multi-speaker")
            self.speaker_mode = cfg.model_type
            self.speaker_embedding = nn.Parameter(
                torch.randn(cfg.num_speakers, S) * 0.5)
        if self.speaker_mode == "deepvoice":
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
        simple_dim = S if self.speaker_mode == "simple" else 0
        self.memory_layer = nn.Linear(enc_dim, cfg.attention_size, bias=False)
        self.decoder = Decoder(cfg, audio.num_mels, enc_dim, dt, simple_dim)
        self.post_cbhg = CBHG(
            audio.num_mels, cfg.post_bank_size, cfg.post_bank_channel_size,
            cfg.post_maxpool_width, cfg.post_highway_depth, cfg.post_rnn_size,
            cfg.post_proj_sizes, cfg.post_proj_width, dt)
        self.linear_projection = nn.Linear(simple_dim + 2 * cfg.post_rnn_size,
                                           audio.num_freq)

    def encode(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
               speaker_id: Optional[torch.Tensor] = None,
               prenet_masks: Optional[Sequence[torch.Tensor]] = None,
               train: bool = False,
               bn_updates: Optional[BNUpdates] = None) -> Encoded:
        """inputs [B, T_in] ids, input_lengths [B] (EOS included),
        speaker_id [B] (valid, non-negative ids: the caller checks them),
        ``prenet_masks`` [B, T_in, size] per layer (dropout) or None."""
        cfg = self.cfg
        table = torch.cat([torch.zeros_like(self.char_embedding[:1]),
                           self.char_embedding[1:]])   # PAD row zeroed
        char_embedded = table[inputs]
        before_highway = enc_init = init_states = simple = None
        if self.speaker_mode is not None:
            spk = self.speaker_embedding[speaker_id]
        if self.speaker_mode == "simple":
            simple = spk
        elif self.speaker_mode == "deepvoice":
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
        prenet_out = self.encoder_prenet(
            char_embedded, None if prenet_masks is None
            else self.encoder_prenet.scales_from_masks(prenet_masks))
        encoder_outputs = self.encoder_cbhg(prenet_out, input_lengths,
                                            before_highway, enc_init, train,
                                            bn_updates)
        T_in = inputs.shape[1]
        mask = (torch.arange(T_in, device=inputs.device)[None, :]
                < input_lengths[:, None])
        values = encoder_outputs * mask[..., None]
        keys = dense(self.memory_layer, values)           # float32
        return Encoded(keys, values, mask, init_states, simple)

    def postnet(self, mel: torch.Tensor, train: bool = False,
                bn_updates: Optional[BNUpdates] = None,
                speaker_embed: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """mel [B, T, M] (compute type) -> linear [B, T, num_freq];
        ``speaker_embed`` [B, S] (the ``simple`` mode) is tiled over time
        ahead of the post-net's output."""
        post = self.post_cbhg(mel, train=train, bn_updates=bn_updates)
        if speaker_embed is not None:
            B, T, _ = post.shape
            tiled = speaker_embed[:, None, :].to(post.dtype).expand(B, T, -1)
            post = torch.cat([tiled, post], dim=-1)
        return dense(self.linear_projection, post, self.dtype)

    def draw_prenet_masks(self, max_iters: int, batch: int,
                          generator: torch.Generator) -> List[torch.Tensor]:
        """Decoder-prenet keep-masks for a whole decode, [max_iters, B,
        size] per layer, drawn from ``generator`` on its device."""
        return self.decoder.step.decoder_prenet.draw_masks(
            (max_iters, batch), generator, generator.device)

    def draw_encoder_masks(self, batch: int, T_in: int,
                           generator: torch.Generator) -> List[torch.Tensor]:
        """Encoder-prenet keep-masks for training, [B, T_in, size] per
        layer, drawn from ``generator`` on its device."""
        return self.encoder_prenet.draw_masks((batch, T_in), generator,
                                              generator.device)

    def running_stats(self, bn_updates: BNUpdates) -> Dict[str, torch.Tensor]:
        """``bn_updates`` under the ``state_dict`` names of the running
        statistics (``<module>.bn.running_mean`` / ``running_var``)."""
        out = {}
        for name, module in self.named_modules():
            if module in bn_updates:
                mean, var = bn_updates[module]
                out[f"{name}.bn.running_mean"] = mean
                out[f"{name}.bn.running_var"] = var
        return out

    def forward(self, inputs: torch.Tensor, input_lengths: torch.Tensor,
                speaker_id: Optional[torch.Tensor] = None,
                max_iters: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                manual_alignments: Optional[torch.Tensor] = None,
                mel_targets: Optional[torch.Tensor] = None,
                train: bool = False, free_run: bool = False,
                use_teacher: Optional[torch.Tensor] = None,
                encoder_prenet_masks: Optional[Sequence[torch.Tensor]] = None,
                bn_updates: Optional[BNUpdates] = None
                ) -> Dict[str, torch.Tensor]:
        """Without ``mel_targets``: a free-run decode over a static
        ``max_iters`` (default the config's).  With ``mel_targets`` [B,
        T_out, M] (T_out a multiple of r): T_out / r steps, teacher-forced
        unless ``free_run``; ``use_teacher`` [T_dec, B] (bool) mixes the
        model's own frames in where it is False (scheduled sampling).

        ``train``: batch norm from the batch (new statistics into
        ``bn_updates``) and dropout in both prenets, from
        ``encoder_prenet_masks`` / ``prenet_masks`` or else drawn from
        ``generator`` (at a dropout rate of 0 there is none, as in flax).
        Not training, decoder-prenet dropout is ``prenet_masks`` if given,
        else drawn from ``generator`` when the config keeps it on at
        inference, else none."""
        cfg = self.cfg
        B, T_in = inputs.shape
        dropout = train and cfg.dropout_prob > 0
        if (dropout and generator is None
                and (prenet_masks is None or encoder_prenet_masks is None)):
            raise ValueError("training with dropout needs its keep-masks "
                             "or a generator")
        if dropout and encoder_prenet_masks is None:
            encoder_prenet_masks = self.draw_encoder_masks(B, T_in, generator)
        if not dropout:
            encoder_prenet_masks = None
        enc = self.encode(inputs, input_lengths, speaker_id,
                          encoder_prenet_masks, train, bn_updates)
        r = cfg.reduction_factor
        teacher = None
        if mel_targets is not None:
            max_steps = mel_targets.shape[1] // r
            if not free_run:
                block_last = mel_targets[:, r - 1::r].transpose(0, 1)
                teacher = torch.cat([torch.zeros_like(block_last[:1]),
                                     block_last[:-1]])
        else:
            max_steps = max_iters or cfg.max_iters
        if train and not dropout:
            prenet_masks = None
        elif prenet_masks is None and generator is not None and (
                dropout or cfg.dec_prenet_dropout_inference):
            prenet_masks = self.draw_prenet_masks(max_steps, B, generator)
        mel, alignments = self.decoder(
            enc, max_steps, prenet_masks, manual_alignments, teacher,
            None if teacher is None else use_teacher)
        linear = self.postnet(mel, train, bn_updates, enc.speaker_embed)
        return {"mel_outputs": mel.float(),
                "linear_outputs": linear.float(),
                "alignments": alignments.float()}


def tacotron_loss(outputs: Dict[str, torch.Tensor],
                  mel_targets: torch.Tensor, linear_targets: torch.Tensor,
                  loss_coeff: torch.Tensor, cfg: TacotronConfig,
                  audio: AudioConfig) -> Dict[str, torch.Tensor]:
    """L1 mel + L1 linear weighted per example by ``loss_coeff``, with the
    165-5,000 Hz band of the linear loss counted twice when
    ``prioritize_loss`` is set; float32."""
    mel_l1 = torch.abs(mel_targets - outputs["mel_outputs"])
    lin_l1 = torch.abs(linear_targets - outputs["linear_outputs"])
    coeff = loss_coeff[:, None, None]
    if cfg.prioritize_loss:
        upper = int(5000 / (audio.sample_rate * 0.5) * audio.num_freq)
        lower = int(165 / (audio.sample_rate * 0.5) * audio.num_freq)
        priority = lin_l1[:, :, lower:upper]
        loss = (torch.mean(mel_l1 * coeff)
                + 0.5 * torch.mean(lin_l1 * coeff)
                + 0.5 * torch.mean(priority * coeff))
        linear_loss = 0.5 * (torch.mean(lin_l1) + torch.mean(priority))
    else:
        loss = torch.mean(mel_l1 * coeff) + torch.mean(lin_l1 * coeff)
        linear_loss = torch.mean(lin_l1)
    mel_loss = torch.mean(mel_l1)
    return {"loss": loss, "mel_loss": mel_loss, "linear_loss": linear_loss,
            "loss_without_coeff": mel_loss + linear_loss}


def scheduled_sampling_prob(cfg: TacotronConfig, step: torch.Tensor
                            ) -> torch.Tensor:
    """The teacher-forcing probability at ``step`` (a tensor): 1 until
    ``ss_start_step``, then linear to ``ss_final_prob`` over
    ``ss_ramp_steps``, constant after; float32."""
    s = step.to(torch.float32)
    frac = torch.clamp((s - cfg.ss_start_step) / max(cfg.ss_ramp_steps, 1),
                       0.0, 1.0)
    return 1.0 + frac * (cfg.ss_final_prob - 1.0)


def learning_rate_schedule(cfg: TacotronConfig,
                           is_randomly_initialized: bool = False):
    """``step -> learning rate`` (float32 tensors).  Mode 0: Noam's warmup,
    ``lr0 * w^0.5 * min(s * w^-1.5, s^-0.5)`` at s = step + 1, w = 4,000
    for a randomly initialized run (a fresh one or a resumed one), else
    40,000; mode 1: ``lr0 * 0.95^(s / 3000)``."""
    warmup = 4000.0 if is_randomly_initialized else 40000.0

    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32) + 1.0
        if cfg.decay_learning_rate_mode == 1:
            return cfg.initial_learning_rate * torch.pow(
                torch.full_like(s, 0.95), s / 3000.0)
        return (cfg.initial_learning_rate * warmup ** 0.5
                * torch.minimum(s * warmup ** -1.5, torch.pow(s, -0.5)))

    return schedule
