"""The WaveNet batcher: random hop-aligned crops of (audio, mel) windows
from preprocessed ``.npz`` clips (counterpart of the JAX package's
``data/loader.py`` ``WaveNetBatcher``, ``WaveNetBatch`` and
``round_up``).

The selection is the JAX batcher's draw for draw: one
``np.random.RandomState`` stream picks the clips (per data dir, in
shuffled epochs) and the frame offsets, and shuffles each group.  Host
batches are numpy ``WaveNetBatch``es.  With ``device_store=True`` every
padded clip lives on the device (audio float32, mel float16, as in JAX)
and a batch is cut there by indexing with B clip ids and B frame offsets,
the only data that crosses to the device per step.  The Tacotron batcher
is not ported yet.
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


def round_up(x: int, multiple: int) -> int:
    r = x % multiple
    return x if r == 0 else x + multiple - r


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
    """

    def __init__(self, data_dirs: Sequence[str], cfg: Config,
                 batch_size: Optional[int] = None, gc_enable: bool = False,
                 seed: Optional[int] = None, batches_per_group: int = 32,
                 device_store: bool = False, data_type: str = "train",
                 device: Union[str, torch.device, None] = None):
        if data_type not in ("train", "test"):
            raise ValueError(f"data_type={data_type!r}")
        self.data_type = data_type
        self.cfg = cfg
        self.batch_size = batch_size or cfg.wavenet.batch_size
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
            self.device = resolve_device(device)
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
                batch = examples[i:i + n]
                if self.device_store:
                    yield self._gather(np.array([b[0] for b in batch]),
                                       np.array([b[1] for b in batch]))
                    continue
                yield WaveNetBatch(
                    input_wav=np.stack([b[0] for b in batch]),
                    local_condition=np.stack([b[1] for b in batch]),
                    speaker_id=np.asarray([b[2] for b in batch], np.int32),
                )
