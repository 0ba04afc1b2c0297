"""The batchers of training (counterpart of the JAX package's
``data/loader.py``): ``TacotronBatcher``, length-bucketed padded batches of
whole examples, and ``WaveNetBatcher``, random hop-aligned crops of
(audio, mel) windows, both from preprocessed ``.npz`` clips.

Tacotron: ``scan_npz_dir`` lists a dir's usable examples (frame and token
filter, the son / yuinna blacklist); the batcher holds out the last
``num_test_per_speaker`` of each dir's shuffled list, draws a group of
``batch_size x batches_per_group`` examples by the dirs' data ratios (even
shares before ``initial_phase_step``), sorts it by length, cuts it into
batches and shuffles them; a batch pads tokens to a multiple of 16 and
frames to ``max + 1`` rounded up to r and then to r * 10.  The test stream
is one fixed batch, repeated.  With ``device_store=True`` every example
lives on the device (spectrograms float16) and a batch is gathered there
by indexing with its B ids.

The selection is the JAX batcher's draw for draw: one
``np.random.RandomState`` stream picks the clips (per data dir, in
shuffled epochs) and the frame offsets, and shuffles each group.  Host
batches are numpy ``WaveNetBatch``es.  With ``device_store=True`` every
padded clip lives on the device (audio float32, mel float16, as in JAX)
and a batch is cut there by indexing with B clip ids and B frame offsets,
the only data that crosses to the device per step.

With ``mesh=`` (a ``parallel.Mesh``) every rank runs the same
``RandomState`` stream, so every rank draws the same global batch of
``batch_size`` examples, and keeps its rows ``[d * B / n_data, (d + 1) * B
/ n_data)``, ``d`` its data coordinate; a Tacotron batch is padded to the
global batch's bucket.  The device store is held whole on every rank (the
JAX store shards its example dim over the data axis instead).
"""
from __future__ import annotations

import glob
import os
import warnings
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device


PAD_VALUE = 0


def round_up(x: int, multiple: int) -> int:
    r = x % multiple
    return x if r == 0 else x + multiple - r


def mesh_rows(batch_size: int, mesh) -> slice:
    """This rank's rows of a global batch of ``batch_size`` (all of them
    without a mesh); ``batch_size % n_data`` must be 0."""
    if mesh is None or mesh.n_data == 1:
        return slice(None)
    if batch_size % mesh.n_data:
        raise ValueError(f"batch_size={batch_size} does not split over "
                         f"{mesh.n_data} data ranks")
    n = batch_size // mesh.n_data
    d = mesh.coords[0]
    return slice(d * n, (d + 1) * n)


@dataclass
class TacotronBatch:
    inputs: np.ndarray          # [B, T_in] int32
    input_lengths: np.ndarray   # [B] int32
    loss_coeff: np.ndarray      # [B] float32
    mel_targets: np.ndarray     # [B, T_out, num_mels] float32
    linear_targets: np.ndarray  # [B, T_out, num_freq] float32
    speaker_id: np.ndarray      # [B] int32 (zeros with one speaker)


def scan_npz_dir(data_dir: str, cfg: Config,
                 apply_filter: bool = True) -> List[str]:
    """A dir's usable ``*.npz``, sorted: with ``apply_filter``, those of
    ``r * min_iters`` to ``r * max_iters - r`` frames and at least
    ``min_tokens`` tokens (an unreadable file is skipped), without the
    known-bad clips of a son or yuinna corpus."""
    paths = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not apply_filter:
        return paths
    t = cfg.tacotron
    min_n_frame = t.reduction_factor * t.min_iters
    max_n_frame = t.reduction_factor * t.max_iters - t.reduction_factor
    keep = []
    for p in paths:
        try:
            with np.load(p) as d:
                n_frame = d["linear"].shape[0]
                n_tokens = len(d["tokens"])
        except Exception:
            continue
        if min_n_frame <= n_frame <= max_n_frame and n_tokens >= t.min_tokens:
            keep.append(p)
    if any(tag in data_dir for tag in ("son", "yuinna")):
        blacklist = (".0000.", ".0001.", "NB11479580.0001")
        keep = [p for p in keep
                if not any(b in os.path.basename(p) for b in blacklist)]
    return keep


class TacotronBatcher:
    """An endless iterator over length-bucketed padded batches.

    ``data_dirs`` map to speaker ids by position.  ``data_type`` 'train'
    serves each dir's shuffled list but its last ``num_test_per_speaker``
    (all of it when the list is no longer), 'test' those last ones, as one
    fixed batch repeated.  ``apply_filter`` defaults to ``not
    train.skip_path_filter``.  Every draw (path shuffles, group shuffles,
    batch shuffles) comes from one ``np.random.RandomState`` in the JAX
    batcher's order, so both serve the same batches.  ``step`` counts the
    batches served (the curriculum reads it; a resumed run sets it).

    Host batches are ``TacotronBatch``es.  ``device_store=True`` (train
    only) loads every example once onto ``device`` (``cuda`` unless the
    caller asks for another): ids, lengths, coefficients and speaker ids
    as int64 / float32, spectrograms float16, padded to the corpus's
    bucketed maxima; a batch is a dict of tensors there with
    ``train.tacotron_task.batch_to_device``'s keys, gathered by indexing
    with its B ids and cut to its bucket.  ``store_bytes`` is the store's
    size.  ``mesh``: this rank's rows of each batch (module docstring),
    on the mesh's device."""

    def __init__(self, data_dirs: Sequence[str], cfg: Config,
                 data_type: str = "train", batch_size: Optional[int] = None,
                 batches_per_group: int = 32,
                 apply_filter: Optional[bool] = None,
                 token_bucket: int = 16, frame_bucket_iters: int = 10,
                 seed: Optional[int] = None, device_store: bool = False,
                 device: Union[str, torch.device, None] = None, mesh=None):
        if data_type not in ("train", "test"):
            raise ValueError(f"data_type={data_type!r}")
        if device_store and data_type == "test":
            raise ValueError("device_store is for the train stream")
        self.cfg = cfg
        self.data_type = data_type
        self.batch_size = batch_size or cfg.tacotron.batch_size
        self.rows = mesh_rows(self.batch_size, mesh)
        self.batches_per_group = batches_per_group
        self.token_bucket = token_bucket
        self.frame_bucket = cfg.tacotron.reduction_factor * frame_bucket_iters
        self.rng = np.random.RandomState(
            cfg.train.random_seed if seed is None else seed)
        self.step = 0

        self.data_dirs = list(data_dirs)
        self.dir_to_id = {d: i for i, d in enumerate(self.data_dirs)}
        self.path_dict: Dict[str, List[str]] = {}
        n_test = max(1, cfg.train.num_test_per_speaker)
        if apply_filter is None:
            apply_filter = not cfg.train.skip_path_filter
        for d in self.data_dirs:
            paths = scan_npz_dir(d, cfg, apply_filter)
            if not paths:
                raise ValueError(f"no usable npz files in {d}")
            self.rng.shuffle(paths)
            if data_type == "train":
                split = paths[:-n_test] if len(paths) > n_test else paths
            else:
                split = paths[-n_test:]
            self.path_dict[d] = split

        t = cfg.tacotron
        weights = {d: 1.0 for d in self.data_dirs}
        if t.main_data_greedy_factor > 0:
            for main in t.main_data:
                for d in self.data_dirs:
                    if main and main in d:
                        weights[d] += t.main_data_greedy_factor
        z = sum(weights.values())
        self.data_ratio = {d: w / z for d, w in weights.items()}
        self._offset = defaultdict(int)

        self.device_store = device_store
        if device_store:
            self.device = resolve_device(mesh.device if mesh else device)
            self._build_store()

    # ------------------------------------------------------------------
    # Device-resident store
    # ------------------------------------------------------------------
    def _build_store(self) -> None:
        records = []          # (tokens, coeff, mel, linear, sid, n_frames)
        self.idx_dict: Dict[str, List[int]] = {}
        for d in self.data_dirs:
            idxs = []
            for p in self.path_dict[d]:
                try:
                    with np.load(p) as f:
                        rec = (np.asarray(f["tokens"], np.int64),
                               float(f["loss_coeff"])
                               if "loss_coeff" in f else 1.0,
                               np.asarray(f["mel"], np.float16),
                               np.asarray(f["linear"], np.float16),
                               self.dir_to_id[d])
                except Exception:
                    continue      # an unreadable npz leaves the corpus
                idxs.append(len(records))
                records.append(rec + (rec[3].shape[0],))
            if not idxs:
                raise ValueError(f"no readable npz files in {d}")
            self.idx_dict[d] = idxs

        n = len(records)
        t_max = round_up(max(len(r[0]) for r in records), self.token_bucket)
        r_factor = self.cfg.tacotron.reduction_factor
        f_max = round_up(max(r[-1] for r in records) + 1, r_factor)
        f_max = round_up(f_max, self.frame_bucket)
        num_mels = records[0][2].shape[1]
        num_freq = records[0][3].shape[1]
        inputs = np.full((n, t_max), PAD_VALUE, np.int64)
        lengths = np.zeros(n, np.int64)
        coeffs = np.zeros(n, np.float32)
        mels = np.zeros((n, f_max, num_mels), np.float16)
        linears = np.zeros((n, f_max, num_freq), np.float16)
        speakers = np.zeros(n, np.int64)
        self.store_meta = []                 # (n_tokens, n_frames) per idx
        for i, (tok, coeff, mel, lin, sid, n_frame) in enumerate(records):
            inputs[i, :len(tok)] = tok
            lengths[i] = len(tok)
            coeffs[i] = coeff
            mels[i, :n_frame] = mel
            linears[i, :n_frame] = lin
            speakers[i] = sid
            self.store_meta.append((len(tok), n_frame))
        host = {"inputs": inputs, "input_lengths": lengths,
                "loss_coeff": coeffs, "mel_targets": mels,
                "linear_targets": linears, "speaker_id": speakers}
        self.store = {k: torch.from_numpy(v).to(self.device)
                      for k, v in host.items()}
        self.store_bytes = sum(v.numel() * v.element_size()
                               for v in self.store.values())

    def _gather(self, idx: np.ndarray, max_tokens: int, max_frames: int
                ) -> Dict[str, torch.Tensor]:
        """Rows ``idx`` of the store cut to the bucket, on the device: one
        [B] int64 copy to the device (from pinned memory on a card), then
        one indexing op per key."""
        sel = torch.from_numpy(np.asarray(idx, np.int64))
        if self.device.type == "cuda":
            sel = sel.pin_memory()
        sel = sel.to(self.device, non_blocking=True)
        s = self.store
        return {"inputs": s["inputs"][sel, :max_tokens],
                "input_lengths": s["input_lengths"][sel],
                "loss_coeff": s["loss_coeff"][sel],
                "mel_targets": s["mel_targets"][sel, :max_frames],
                "linear_targets": s["linear_targets"][sel, :max_frames],
                "speaker_id": s["speaker_id"][sel]}

    def _next_example_store(self, data_dir: str):
        idxs = self.idx_dict[data_dir]
        if self._offset[data_dir] >= len(idxs):
            self._offset[data_dir] = 0
            if self.data_type == "train":
                self.rng.shuffle(idxs)
        i = idxs[self._offset[data_dir]]
        self._offset[data_dir] += 1
        n_tokens, n_frames = self.store_meta[i]
        return (i, n_tokens, n_frames)

    def _next_example(self, data_dir: str):
        if self.device_store:
            return self._next_example_store(data_dir)
        paths = self.path_dict[data_dir]
        for _ in range(len(paths)):
            if self._offset[data_dir] >= len(paths):
                self._offset[data_dir] = 0
                if self.data_type == "train":
                    self.rng.shuffle(paths)
            p = paths[self._offset[data_dir]]
            self._offset[data_dir] += 1
            try:
                with np.load(p) as d:
                    tokens = np.asarray(d["tokens"], dtype=np.int32)
                    mel = np.asarray(d["mel"], dtype=np.float32)
                    linear = np.asarray(d["linear"], dtype=np.float32)
                    coeff = (float(d["loss_coeff"]) if "loss_coeff" in d
                             else 1.0)
            except Exception:
                # an unreadable npz leaves the epoch
                paths.remove(p)
                self._offset[data_dir] = min(self._offset[data_dir],
                                             len(paths))
                continue
            return (tokens, coeff, mel, linear, self.dir_to_id[data_dir],
                    linear.shape[0])
        raise RuntimeError(f"no readable npz files remain in {data_dir}")

    def _group(self) -> List[list]:
        n = self.batch_size
        t = self.cfg.tacotron
        examples = []
        for d in self.data_dirs:
            if self.step < t.initial_phase_step:
                count = n * self.batches_per_group // len(self.data_dirs)
            else:
                count = int(n * self.batches_per_group * self.data_ratio[d])
            examples.extend(self._next_example(d) for _ in range(count))
        examples.sort(key=lambda x: x[-1])  # by target length
        batches = [examples[i:i + n] for i in range(0, len(examples), n)
                   if len(examples[i:i + n]) == n]
        self.rng.shuffle(batches)
        return batches

    def _bucket(self, n_tokens: int, n_frames: int):
        r = self.cfg.tacotron.reduction_factor
        max_tokens = round_up(n_tokens, self.token_bucket)
        max_frames = round_up(round_up(n_frames + 1, r), self.frame_bucket)
        return max_tokens, max_frames

    def _prepare(self, batch: list):
        if self.data_type == "train":
            self.rng.shuffle(batch)
        if self.device_store:
            max_tokens, max_frames = self._bucket(max(x[1] for x in batch),
                                                  max(x[2] for x in batch))
            return self._gather(np.asarray([x[0] for x in batch[self.rows]]),
                                max_tokens, max_frames)
        max_tokens, max_frames = self._bucket(max(len(x[0]) for x in batch),
                                              max(x[-1] for x in batch))
        batch = batch[self.rows]
        B = len(batch)
        inputs = np.full((B, max_tokens), PAD_VALUE, np.int32)
        lengths = np.zeros(B, np.int32)
        coeffs = np.zeros(B, np.float32)
        mels = np.zeros((B, max_frames, batch[0][2].shape[1]), np.float32)
        linears = np.zeros((B, max_frames, batch[0][3].shape[1]), np.float32)
        speakers = np.zeros(B, np.int32)
        for i, (tokens, coeff, mel, linear, sid, n_frame) in enumerate(batch):
            inputs[i, :len(tokens)] = tokens
            lengths[i] = len(tokens)
            coeffs[i] = coeff
            mels[i, :n_frame] = mel
            linears[i, :n_frame] = linear
            speakers[i] = sid
        return TacotronBatch(inputs, lengths, coeffs, mels, linears, speakers)

    def __iter__(self) -> Iterator[Union[TacotronBatch,
                                         Dict[str, torch.Tensor]]]:
        if self.data_type == "test":
            examples = []
            while len(examples) < self.batch_size:
                for d in self.data_dirs:
                    examples.append(self._next_example(d))
                    if len(examples) >= self.batch_size:
                        break
            batch = self._prepare(examples)
            while True:
                yield batch
        while True:
            for batch in self._group():
                self.step += 1
                yield self._prepare(batch)


@dataclass
class WaveNetBatch:
    input_wav: np.ndarray        # [B, sample_size, 1] float32
    local_condition: np.ndarray  # [B, sample_size // hop, num_mels] float32
    speaker_id: np.ndarray       # [B] int32


class WaveNetBatcher:
    """An endless iterator over batches of random hop-aligned crops.

    ``data_dirs`` map to speaker ids by position.  A clip is used when its
    ``time_steps`` exceed ``max(sample_size, receptive_field)``; the list
    comes from a dir's ``train.txt`` when it has one, else from its
    ``*.npz``.  ``data_type``: 'train' leaves out, and 'test' serves, the
    last ``train.num_test_per_speaker`` usable clips of each dir in sorted
    order; a dir with fewer than twice that many keeps every clip in both
    streams (and 'test' warns).  The corpus's audio dtype must match
    ``wavenet.input_type`` (int class ids for ``mulaw-quantize``, floats
    otherwise), or construction raises ``ValueError``.

    ``device_store=True`` keeps every clip on ``device`` (``cuda`` unless
    the caller asks for another) and yields dicts of tensors there with
    the keys of ``train.wavenet_task.batch_to_device``: ``input_wav`` [B,
    T, 1] and ``local_condition`` [B, T // hop, num_mels] float32,
    ``speaker_id`` [B] int64.  ``store_bytes`` is the store's size.
    ``mesh``: this rank's rows of each batch (module docstring), on the
    mesh's device.
    """

    def __init__(self, data_dirs: Sequence[str], cfg: Config,
                 batch_size: Optional[int] = None, gc_enable: bool = False,
                 seed: Optional[int] = None, batches_per_group: int = 32,
                 device_store: bool = False, data_type: str = "train",
                 device: Union[str, torch.device, None] = None, mesh=None):
        if data_type not in ("train", "test"):
            raise ValueError(f"data_type={data_type!r}")
        self.data_type = data_type
        self.cfg = cfg
        self.batch_size = batch_size or cfg.wavenet.batch_size
        self.rows = mesh_rows(self.batch_size, mesh)
        self.gc_enable = gc_enable
        self.batches_per_group = batches_per_group
        self.hop_size = cfg.audio.hop_size
        self.sample_size = (cfg.wavenet.sample_size
                            // self.hop_size) * self.hop_size
        self.max_frames = self.sample_size // self.hop_size
        self.rng = np.random.RandomState(
            cfg.train.random_seed if seed is None else seed)

        self.data_dirs = list(data_dirs)
        self.dir_to_id = {d: i for i, d in enumerate(self.data_dirs)}
        # A group draws this many clips from each dir; a group smaller
        # than a batch would yield nothing, for ever (the JAX batcher
        # loops so; the port refuses).
        self._per_dir = (self.batch_size * batches_per_group
                         // len(self.data_dirs))
        if self._per_dir * len(self.data_dirs) < self.batch_size:
            raise ValueError(
                f"batch_size={self.batch_size} x batches_per_group="
                f"{batches_per_group} draws no full batch from "
                f"{len(self.data_dirs)} dirs")
        min_length = max(self.sample_size, cfg.wavenet.receptive_field)
        self.path_dict: Dict[str, List[str]] = {}
        for d in self.data_dirs:
            paths = []
            train_txt = os.path.join(d, "train.txt")
            if os.path.exists(train_txt):
                with open(train_txt, encoding="utf-8") as f:
                    for line in f:
                        parts = line.strip().split("|")
                        if len(parts) >= 4 and int(parts[1]) > min_length:
                            paths.append(os.path.join(d, parts[0]))
            else:
                for p in sorted(glob.glob(os.path.join(d, "*.npz"))):
                    with np.load(p) as npz:
                        if int(npz["time_steps"]) > min_length:
                            paths.append(p)
            if not paths:
                raise ValueError(
                    f"no npz with time_steps > {min_length} in {d}")
            n_test = max(1, cfg.train.num_test_per_speaker)
            if len(paths) >= 2 * n_test:
                held = set(sorted(paths)[-n_test:])
                paths = (sorted(held) if data_type == "test"
                         else [p for p in paths if p not in held])
            elif data_type == "test":
                warnings.warn(
                    f"{d}: only {len(paths)} usable clips (< 2x "
                    f"num_test_per_speaker={n_test}) — test stream serves "
                    f"TRAINING clips; test_loss will understate the gap")
            self.path_dict[d] = paths

            # Corpora are companded when they are preprocessed
            # (mulaw-quantize stores int16 class ids, raw and mulaw float32
            # in [-1, 1]); training one with another input_type would
            # converge to garbage, so the storage dtype is checked here.
            with np.load(self.path_dict[d][0]) as f0:
                dt = f0["audio"].dtype
            quantized = cfg.wavenet.input_type == "mulaw-quantize"
            if quantized != np.issubdtype(dt, np.integer):
                raise ValueError(
                    f"{d}: corpus audio dtype {dt} does not match "
                    f"wavenet.input_type={cfg.wavenet.input_type!r} — "
                    f"re-run preprocess.py with the intended input_type "
                    f"(quantized corpora store int class ids)")
        self._offset = defaultdict(int)

        self.device_store = device_store
        if device_store:
            self.device = resolve_device(mesh.device if mesh else device)
            self._build_store()

    # ------------------------------------------------------------------
    # Device-resident store: every padded clip on the device, crops cut
    # there by indexing.
    # ------------------------------------------------------------------
    def _build_store(self) -> None:
        records = []                        # (audio [L], mel [F, M], sid)
        self.idx_dict: Dict[str, List[int]] = {}
        for d in self.data_dirs:
            idxs = []
            for p in self.path_dict[d]:
                with np.load(p) as f:
                    audio = np.asarray(f["audio"], np.float32).reshape(-1)
                    mel = np.asarray(f["mel"], np.float16)
                if len(audio) != len(mel) * self.hop_size:
                    raise ValueError(f"{p}: {len(audio)} samples for "
                                     f"{len(mel)} frames")
                idxs.append(len(records))
                records.append((audio, mel, self.dir_to_id[d]))
            self.idx_dict[d] = idxs

        n = len(records)
        f_max = max(r[1].shape[0] for r in records)
        num_mels = records[0][1].shape[1]
        audio_arr = np.zeros((n, f_max * self.hop_size), np.float32)
        mel_arr = np.zeros((n, f_max, num_mels), np.float16)
        self.store_frames = np.zeros(n, np.int64)
        sids = np.zeros(n, np.int64)
        for i, (audio, mel, sid) in enumerate(records):
            audio_arr[i, :len(audio)] = audio
            mel_arr[i, :len(mel)] = mel
            self.store_frames[i] = len(mel)
            sids[i] = sid

        self._store_audio = torch.from_numpy(audio_arr).to(self.device)
        self._store_mel = torch.from_numpy(mel_arr).to(self.device)
        self._store_sid = torch.from_numpy(sids).to(self.device)
        self.store_bytes = sum(
            t.numel() * t.element_size()
            for t in (self._store_audio, self._store_mel, self._store_sid))
        self._sample_pos = torch.arange(self.sample_size, device=self.device)
        self._frame_pos = torch.arange(self.max_frames, device=self.device)

    def _gather(self, idx: np.ndarray, frame_off: np.ndarray
                ) -> Dict[str, torch.Tensor]:
        """The crops of clips ``idx`` from frames ``frame_off``, cut on the
        device: one [2, B] int64 copy to the device (from pinned memory on
        a card, so the host does not wait for the card), then three
        indexing ops."""
        sel = torch.from_numpy(np.stack([idx, frame_off]).astype(np.int64))
        if self.device.type == "cuda":
            sel = sel.pin_memory()
        sel = sel.to(self.device, non_blocking=True)
        i, s = sel[0][:, None], sel[1][:, None]
        audio = self._store_audio[i, s * self.hop_size + self._sample_pos]
        mel = self._store_mel[i, s + self._frame_pos]
        return {"input_wav": audio[:, :, None],
                "local_condition": mel.float(),
                "speaker_id": self._store_sid[sel[0]]}

    def _next_example(self, data_dir: str):
        paths = (self.idx_dict[data_dir] if self.device_store
                 else self.path_dict[data_dir])
        if self._offset[data_dir] >= len(paths):
            self._offset[data_dir] = 0
            self.rng.shuffle(paths)
        p = paths[self._offset[data_dir]]
        self._offset[data_dir] += 1
        if self.device_store:
            n_frames = int(self.store_frames[p])
            s = self.rng.randint(0, n_frames - self.max_frames + 1)
            return (p, s)
        with np.load(p) as d:
            audio = np.asarray(d["audio"], dtype=np.float32).reshape(-1, 1)
            mel = np.asarray(d["mel"], dtype=np.float32)
        if len(audio) != len(mel) * self.hop_size:
            raise ValueError(f"{p}: {len(audio)} samples for {len(mel)} "
                             "frames")
        s = self.rng.randint(0, len(mel) - self.max_frames + 1)
        ts = s * self.hop_size
        return (audio[ts:ts + self.sample_size],
                mel[s:s + self.max_frames],
                self.dir_to_id[data_dir])

    def __iter__(self) -> Iterator[Union[WaveNetBatch,
                                         Dict[str, torch.Tensor]]]:
        n = self.batch_size
        while True:
            examples = []
            for d in self.data_dirs:
                examples.extend(self._next_example(d)
                                for _ in range(self._per_dir))
            self.rng.shuffle(examples)
            for i in range(0, len(examples) - n + 1, n):
                batch = examples[i:i + n][self.rows]
                if self.device_store:
                    yield self._gather(np.array([b[0] for b in batch]),
                                       np.array([b[1] for b in batch]))
                    continue
                yield WaveNetBatch(
                    input_wav=np.stack([b[0] for b in batch]),
                    local_condition=np.stack([b[1] for b in batch]),
                    speaker_id=np.asarray([b[2] for b in batch], np.int32),
                )
