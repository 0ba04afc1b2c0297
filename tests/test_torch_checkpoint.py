"""PyTorch port: the JAX-free reader of the committed Orbax checkpoints
(``train/zstd.py``, ``train/ocdbt.py``, ``train/checkpoints.py``) against
``zstandard``, tensorstore's ``ocdbt`` kvstore and Orbax.  The serving
classes it loads are held against JAX in ``test_torch_trained.py``.

Each tarball is unpacked once per test session.  Tolerances are stated per
test; the reader itself is held bit for bit.
"""
import json
import os
import shutil
import tarfile

import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import zstandard

from tacotron_wavenet_vocoder_korean_tpu_torch.train import ocdbt, zstd
from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
    CheckpointReader)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARBALL = {name: os.path.join(REPO, "artifacts", f"{name}.ckpt.tar.gz")
           for name in ("wn_moon", "both_r2")}
STEP = {"wn_moon": 260250, "both_r2": 106000}
ITEMS = {"wn_moon": ("step", "params", "ema_params", "opt_state"),
         "both_r2": ("step", "params", "batch_stats")}
NODE_MAGICS = (ocdbt.NODE_MAGIC.to_bytes(4, "big"),
               ocdbt.MANIFEST_MAGIC.to_bytes(4, "big"))
ZSTD_MAGIC = zstd.FRAME_MAGIC.to_bytes(4, "little")


@pytest.fixture(scope="session")
def run_dirs(tmp_path_factory):
    """Both tarballs, unpacked once: name -> run dir."""
    out = {}
    for name, path in TARBALL.items():
        d = tmp_path_factory.mktemp(name)
        with tarfile.open(path) as tar:
            tar.extractall(d, filter="data")
        out[name] = str(d)
    return out


def db_root(run_dirs, name):
    return os.path.join(run_dirs[name], "ckpt", str(STEP[name]), "default")


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# (a) zstd
# ---------------------------------------------------------------------------

def frames_of(data: bytes):
    """Every zstd frame of an OCDBT file: the body of each node or
    manifest, and each value frame of a data file (which may end in zero
    padding)."""
    pos = 0
    while pos < len(data):
        head = data[pos:pos + 4]
        if head in NODE_MAGICS:
            length = int.from_bytes(data[pos + 4:pos + 12], "little")
            assert data[pos + 12:pos + 14] == b"\x00\x01"   # v0, zstd
            yield data[pos + 14:pos + length - 4]
            pos += length
        elif head == ZSTD_MAGIC:
            dec = zstandard.ZstdDecompressor().decompressobj()
            dec.decompress(data[pos:])
            end = len(data) - len(dec.unused_data)
            yield data[pos:end]
            pos = end
        else:
            assert not any(data[pos:]), f"unknown bytes at {pos}"
            return


@pytest.mark.parametrize("name", ["wn_moon", "both_r2"])
def test_zstd_decodes_every_frame_of_the_checkpoints(run_dirs, name):
    """Every node, manifest and value frame of the checkpoint decodes bit
    for bit as zstandard decodes it."""
    n_frames = n_bytes = 0
    for root, _, files in os.walk(db_root(run_dirs, name)):
        for f in files:
            if f.startswith("_"):
                continue
            with open(os.path.join(root, f), "rb") as fh:
                data = fh.read()
            for frame in frames_of(data):
                want = zstandard.ZstdDecompressor().decompressobj(
                ).decompress(frame)
                assert zstd.decompress(frame) == want, (f, n_frames)
                n_frames += 1
                n_bytes += len(want)
    # wn_moon: 1,414 indirect chunks, the rest inline, plus the nodes.
    assert n_frames > {"wn_moon": 1414, "both_r2": 200}[name]
    assert n_bytes > {"wn_moon": 29e6, "both_r2": 80e6}[name]


def _inputs():
    rng = np.random.default_rng(0)
    text = open(os.path.join(REPO, "PERF.md"), "rb").read()
    return {
        "empty": b"",
        "rle": b"a" * 300_000 + b"b" * 70_000,
        "text_over_128k": (text * (1 + 300_000 // len(text)))[:300_000],
        "random": rng.bytes(150_000),
        "floats": (0.05 * rng.standard_normal(60_000)).astype(
            np.float32).tobytes(),
    }


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "xxh64"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", sorted(_inputs()))
def test_zstd_matches_zstandard_on_made_frames(kind, level, checksum):
    raw = _inputs()[kind]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(raw)
    assert zstd.decompress(frame) == raw


def test_zstd_concatenated_and_skippable_frames_and_xxh64():
    a = zstandard.ZstdCompressor(level=3).compress(b"abc" * 1000)
    b = zstandard.ZstdCompressor(level=1, write_content_size=False
                                 ).compress(b"xyz" * 50_000)
    skip = (zstd.SKIPPABLE_MAGIC + 7).to_bytes(4, "little") + (
        3).to_bytes(4, "little") + b"???"
    assert zstd.decompress(a + skip + b) == b"abc" * 1000 + b"xyz" * 50_000
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in (1, 5, 31, 32, 33, 100):
        data = bytes(range(n))
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert int.from_bytes(frame[-4:], "little") == (
            zstd.xxh64(data) & 0xFFFFFFFF)


def test_zstd_raises_on_malformed_frames():
    """Truncation anywhere, reserved bits, a dictionary, a wrong content
    size or checksum: ValueError naming a byte offset."""
    raw = _inputs()["text_over_128k"][:20_000]
    frame = zstandard.ZstdCompressor(level=3,
                                     write_checksum=True).compress(raw)
    for cut in (3, 5, 7, 12, len(frame) // 2, len(frame) - 5,
                len(frame) - 1):
        with pytest.raises(ValueError, match="at byte"):
            zstd.decompress(frame[:cut])
    bad = bytearray(frame)
    bad[4] |= 0x08                                # reserved bit
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 1]))
    no_check = zstandard.ZstdCompressor(level=3).compress(raw)
    fhd = no_check[4]
    at = 5 + (0 if fhd & 0x20 else 1)             # after the window byte
    size = (1 if fhd & 0x20 else 0, 2, 4, 8)[fhd >> 6]
    assert size and not fhd & 3                   # a size, no dictionary
    wrong = bytearray(no_check)
    wrong[at:at + size] = (int.from_bytes(no_check[at:at + size], "little")
                           + 1).to_bytes(size, "little")
    with pytest.raises(ValueError, match="header says"):
        zstd.decompress(bytes(wrong))
    dict_frame = bytearray(no_check)
    dict_frame[4] |= 1                            # a one-byte dictionary id
    dict_frame[at:at] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(dict_frame))
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\0" * 16)
    with pytest.raises(ValueError, match="padding bit at byte 8"):
        zstd.BackwardBits(b"\x12\x00", 7)     # a stream's last byte is 0


# ---------------------------------------------------------------------------
# (b) OCDBT
# ---------------------------------------------------------------------------

def _interior_db(path: str) -> str:
    """A database with two levels of interior nodes, made by tensorstore
    with small nodes, three commits of inline and indirect values."""
    kv = ts.KvStore.open({
        "driver": "ocdbt", "base": f"file://{path}/",
        "config": {"max_decoded_node_bytes": 600,
                   "max_inline_value_bytes": 30,
                   "compression": {"id": "zstd"}}}).result()
    rng = np.random.default_rng(0)
    for c in range(3):
        with ts.Transaction() as txn:
            for i in range(60):
                kv.with_transaction(txn)[f"key{c}_{i:03d}/x"] = rng.bytes(
                    int(rng.integers(1, 80)))
    return path


@pytest.mark.parametrize("name", ["wn_moon", "both_r2", "interior"])
def test_ocdbt_reads_what_tensorstore_reads(run_dirs, tmp_path, name):
    root = (_interior_db(str(tmp_path / "db")) if name == "interior"
            else db_root(run_dirs, name))
    reader = ocdbt.OcdbtReader(root)
    if name == "interior":
        assert reader.root_ref[3] >= 1            # the root is interior
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}/"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert reader.keys() == keys
    assert len(keys) == {"wn_moon": 4070, "both_r2": 1354,
                         "interior": 180}[name]
    for k in keys:
        assert reader.read(k) == kv.read(k).result().value, k
    with pytest.raises(KeyError):
        reader.read("no/such/key")


def test_ocdbt_reads_only_the_files_a_key_needs(run_dirs, tmp_path):
    """A copy holding only the manifest, the root node and the one data
    file a value lives in still reads that value."""
    src = db_root(run_dirs, "wn_moon")
    reader = ocdbt.OcdbtReader(src)
    key = "ema_params.post_1.kernel/0.0"
    _, keys, entries = reader._node(reader.root_ref)
    path, offset, length = entries[keys.index(key.encode())]
    dst = tmp_path / "default"
    for rel in ("manifest.ocdbt", reader.root_ref[0], path):
        os.makedirs(os.path.dirname(dst / rel), exist_ok=True)
        shutil.copy(os.path.join(src, rel), dst / rel)
    assert len(list((dst / "ocdbt.process_0" / "d").iterdir())) == 1
    assert ocdbt.OcdbtReader(str(dst)).read(key) == reader.read(key)


def test_ocdbt_checks_magic_length_version_and_crc(run_dirs, tmp_path):
    with open(os.path.join(db_root(run_dirs, "wn_moon"), "manifest.ocdbt"),
              "rb") as f:
        raw = f.read()
    magic = ocdbt.MANIFEST_MAGIC
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    assert ocdbt.unwrap(raw, magic, "m")
    for bad, what in ((b"\0" + raw[1:], "magic"), (raw + b"\0", "says"),
                      (raw[:20] + bytes([raw[20] ^ 4]) + raw[21:], "CRC")):
        with pytest.raises(ValueError, match=what):
            ocdbt.unwrap(bad, magic, "m")
    with pytest.raises(ValueError, match="magic"):
        ocdbt.unwrap(raw, ocdbt.NODE_MAGIC, "m")


# ---------------------------------------------------------------------------
# (c) restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["wn_moon", "both_r2"])
def test_restore_equals_orbax_bit_for_bit(run_dirs, name):
    """Every leaf of step, params, ema_params and opt_state (wn_moon: the
    Adam moments and both counts, under sequence indices) / batch_stats:
    same dtype, shape and bytes as Orbax's StandardCheckpointer
    restores."""
    reader = CheckpointReader(run_dirs[name])
    assert reader.latest_step() == STEP[name]
    got = dict(flat(reader.restore(items=ITEMS[name])))
    want = ocp.StandardCheckpointer().restore(db_root(run_dirs, name))
    want = {k: np.asarray(v) for k, v in flat(want) if k[0] in ITEMS[name]}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), k
        assert g.tobytes() == w.tobytes(), k
    assert reader.decoded_bytes == sum(v.nbytes for v in got.values())
    assert int(got[("step",)]) == STEP[name]
    if name == "wn_moon":
        assert sum(k[0] == "opt_state" for k in got) == 1018
        for k in (("opt_state", "0", "count"), ("opt_state", "1", "count")):
            assert int(got[k]) == STEP[name]


def test_reader_takes_the_tarball_the_run_dir_and_its_ckpt_dir(run_dirs):
    """A tarball is unpacked into a temporary directory that close()
    removes; the run dir and its ckpt/ dir read the same."""
    with CheckpointReader(TARBALL["wn_moon"]) as reader:
        tmp = reader.run_dir
        a = reader.restore(items=("step",))
        assert reader.config().wavenet.skip_channels == 512
    assert not os.path.exists(tmp)
    b = CheckpointReader(os.path.join(run_dirs["wn_moon"], "ckpt"))
    assert b.restore(items=("step",)) == a
    assert b.config() == CheckpointReader(run_dirs["wn_moon"]).config()
    with pytest.raises(KeyError, match="opt"):
        b.restore(items=("opt",))
    adam, schedule = b.restore(items=("opt_state",))["opt_state"]
    assert set(adam) == {"count", "mu", "nu"} and set(schedule) == {"count"}


@pytest.mark.parametrize("change", ["chunks", "order", "filters",
                                    "no_chunk"])
def test_restore_refuses_layouts_it_does_not_read(run_dirs, monkeypatch,
                                                  change):
    orig = ocdbt.OcdbtReader.read

    def read(self, key):
        if change == "no_chunk" and not key.endswith(".zarray"):
            raise KeyError(key)
        value = orig(self, key)
        if key.endswith(".zarray"):
            meta = json.loads(value)
            if change == "chunks" and meta["shape"]:
                meta["chunks"] = [1] * len(meta["shape"])
            elif change == "order":
                meta["order"] = "F"
            elif change == "filters":
                meta["filters"] = [{"id": "delta", "dtype": "<f4"}]
            value = json.dumps(meta).encode()
        return value

    monkeypatch.setattr(ocdbt.OcdbtReader, "read", read)
    error = KeyError if change == "no_chunk" else ValueError
    with pytest.raises(error, match="params"):
        CheckpointReader(run_dirs["wn_moon"]).restore(items=("params",))


# ---------------------------------------------------------------------------
# (d) writing: CheckpointManager, restore_into_state
# ---------------------------------------------------------------------------

def _tiny_run(clip: bool):
    """A TINY WaveNet config (the hop of the default audio), the JAX task's
    state after one step as numpy, and the port's state holding the same
    arrays."""
    import jax
    from tacotron_wavenet_vocoder_korean_tpu import config as JC
    from tacotron_wavenet_vocoder_korean_tpu.train.wavenet_task import (
        WaveNetTask as JaxTask)
    from tacotron_wavenet_vocoder_korean_tpu_torch import config as PC
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import (
        from_jax_tree)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask)
    from torch_port_util import plain
    over = {"dilations": [1, 2, 4, 1, 2, 4], "residual_channels": 8,
            "dilation_channels": 8, "skip_channels": 16, "out_channels": 12,
            "initial_filter_width": 8, "sample_size": 1500, "batch_size": 2,
            "clip_gradients": clip}
    jcfg = JC.overlay(JC.Config(), wavenet=over)
    pcfg = PC.overlay(PC.Config(), wavenet=over)
    rng = np.random.RandomState(0)
    batch = {"input_wav": rng.uniform(-0.5, 0.5, (2, 1500, 1)).astype(
        np.float32), "local_condition": rng.randn(2, 5, 80).astype(np.float32),
        "speaker_id": np.zeros(2, np.int32)}
    task = JaxTask(jcfg)
    state = task.init_state(jax.random.PRNGKey(0), batch)
    state, _ = jax.jit(task.train_step)(state, batch)
    jstate = jax.tree.map(np.asarray, state)
    port = from_jax_tree(WaveNetTask(pcfg, device="cpu").init_state(0),
                         plain(jstate))
    return jcfg, pcfg, jstate, port


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_written_run_dir_has_orbax_non_ocdbt_layout(tmp_path):
    """The port's save of a train state (clip on: an EmptyState node)
    against Orbax's StandardCheckpointHandler(use_ocdbt=False) save of the
    same tree: the same files; _METADATA byte for byte; each .zarray equal
    but for the compressor (the port writes none, Orbax zstd); each chunk
    the bytes of Orbax's chunk decompressed; _CHECKPOINT_METADATA with the
    same keys and handler.  The port's reader restores Orbax's save bit for
    bit."""
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager)
    _, _, jstate, port = _tiny_run(clip=True)
    mgr = ocp.CheckpointManager(
        str(tmp_path / "orbax" / "ckpt"),
        options=ocp.CheckpointManagerOptions(max_to_keep=3, create=True),
        item_handlers=ocp.StandardCheckpointHandler(use_ocdbt=False))
    mgr.save(7, args=ocp.args.StandardSave(jstate))
    mgr.wait_until_finished()
    mgr.close()
    CheckpointManager(str(tmp_path / "port")).save(7, port)
    want = tmp_path / "orbax" / "ckpt" / "7"
    got = tmp_path / "port" / "ckpt" / "7"
    assert _files(got) == _files(want)
    read = lambda p: open(p, "rb").read()
    assert read(got / "default" / "_METADATA") == read(
        want / "default" / "_METADATA")
    meta = json.loads(read(got / "default" / "_METADATA"))
    assert {"value_type": "None", "skip_deserialize": True} in [
        v["value_metadata"] for v in meta["tree_metadata"].values()]
    n = 0
    for f in _files(got / "default"):
        if f.endswith(".zarray"):
            g, w = json.loads(read(got / "default" / f)), json.loads(
                read(want / "default" / f))
            assert g["compressor"] is None and w["compressor"]["id"] == "zstd"
            assert dict(g, compressor=None) == dict(w, compressor=None), f
        elif not f.startswith("_"):
            dec = zstandard.ZstdDecompressor().decompressobj()
            assert read(got / "default" / f) == dec.decompress(
                read(want / "default" / f)), f
            n += 1
    assert n == sum(1 for _ in flat(port._asdict()))
    g, w = (json.loads(read(p / "_CHECKPOINT_METADATA")) for p in (got, want))
    assert set(g) == set(w) and g["item_handlers"] == w["item_handlers"]
    restored = CheckpointReader(str(tmp_path / "orbax")).restore(items=None)
    for k, v in flat(jax_tree_plain(jstate)):
        r = dict(flat(restored))[k]
        assert r.dtype == v.dtype and r.tobytes() == v.tobytes(), k


def jax_tree_plain(tree):
    from torch_port_util import plain
    return plain(tree)


@pytest.mark.parametrize("clip", [False, True], ids=["adam", "clip_adam"])
def test_jax_package_restores_and_serves_a_port_run_dir(tmp_path, clip):
    """A run dir the port wrote (prepare_run_dir + CheckpointManager.save):
    the JAX CheckpointManager restores it into the JAX task's state bit for
    bit, and the JAX WaveNetGenerator().load serves its EMA (as
    tests/test_e2e.py serves a JAX run dir): finite wavs in [-1, 1].  The
    port's WaveNetGenerator.from_checkpoint serves the same EMA."""
    import jax
    from tacotron_wavenet_vocoder_korean_tpu.synth.generator import (
        WaveNetGenerator as JaxGenerator)
    from tacotron_wavenet_vocoder_korean_tpu.train.checkpoints import (
        CheckpointManager as JaxManager)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager, prepare_run_dir)
    jcfg, pcfg, jstate, port = _tiny_run(clip)
    log_dir = str(tmp_path / "run")
    prepare_run_dir(log_dir, pcfg)
    CheckpointManager(log_dir).save(int(port.step), port)
    template = jax.tree.map(np.zeros_like, jstate)
    got = JaxManager(log_dir).restore(template)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jstate))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    gen = JaxGenerator().load(log_dir)
    assert gen.step == 1
    np.testing.assert_array_equal(np.asarray(gen.params["post_1"]["kernel"]),
                                  jstate.ema_params["post_1"]["kernel"])
    wav = gen.generate(np.random.RandomState(1).randn(4, 80).astype(
        np.float32))
    assert wav.shape == (4 * 300,) and np.isfinite(wav).all()
    assert np.abs(wav).max() <= 1.0
    from tacotron_wavenet_vocoder_korean_tpu_torch.convert import flatten
    from tacotron_wavenet_vocoder_korean_tpu_torch.synth.generator import (
        WaveNetGenerator)
    port_gen = WaveNetGenerator.from_checkpoint(log_dir, device="cpu")
    assert port_gen.step == 1
    want = flatten(jax.tree.map(np.asarray, gen.params))
    assert set(want) == set(port_gen.params)
    for k, v in want.items():
        assert np.array_equal(port_gen.params[k].numpy(), v), k


def test_restore_into_state_load_and_initialize_semantics(tmp_path):
    """load_path keeps the saved step, initialize_path resets it to 0 and
    keeps the weights and optimizer state, both raise, neither returns the
    state as given; a run dir, its ckpt/ dir and a tarball of it read the
    same; a leaf of the wrong shape raises."""
    import dataclasses
    import torch
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager, restore_into_state)
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.wavenet_task import (
        WaveNetTask)
    _, pcfg, _, port = _tiny_run(clip=False)
    port = port._replace(step=torch.tensor(42, dtype=torch.int32))
    run = tmp_path / "run"
    CheckpointManager(str(run)).save(42, port)
    with tarfile.open(tmp_path / "run.ckpt.tar.gz", "w:gz") as tar:
        tar.add(run, arcname=".")
    fresh = WaveNetTask(pcfg, device="cpu").init_state(5)
    for src in (run, run / "ckpt", tmp_path / "run.ckpt.tar.gz"):
        state, start = restore_into_state(fresh, str(src), None)
        assert start == 42 and int(state.step) == 42
        for k, v in port.params.items():
            assert torch.equal(state.params[k], v), k
        assert torch.equal(state.opt_state[0]["mu"]["post_1/kernel"],
                           port.opt_state[0]["mu"]["post_1/kernel"])
    state, start = restore_into_state(fresh, None, str(run))
    assert start == 0 and int(state.step) == 0
    assert int(state.opt_state[0]["count"]) == 1
    assert torch.equal(state.ema_params["causal_kernel"],
                       port.ema_params["causal_kernel"])
    assert restore_into_state(fresh, None, None) == (fresh, 0)
    with pytest.raises(ValueError, match="exclusive"):
        restore_into_state(fresh, str(run), str(run))
    wide = dataclasses.replace(pcfg, wavenet=dataclasses.replace(
        pcfg.wavenet, skip_channels=32))
    with pytest.raises(ValueError, match="skip_kernel.*expected"):
        restore_into_state(WaveNetTask(wide, device="cpu").init_state(0),
                           str(run), None)


def test_checkpoint_manager_keeps_max_to_keep_and_refuses_a_step_twice(
        tmp_path):
    """max_to_keep 2 over saves 1, 5, 9: steps 5 and 9 remain, 9 is the
    latest and restores as saved; saving step 9 again raises; no temporary
    directory is left behind."""
    import torch
    from tacotron_wavenet_vocoder_korean_tpu_torch.train.checkpoints import (
        CheckpointManager)
    tree = {"step": torch.tensor(0, dtype=torch.int32),
            "params": {"post_1/kernel": torch.zeros(2, 3)}}
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 9):
        tree = {"step": torch.tensor(step, dtype=torch.int32),
                "params": {"post_1/kernel": torch.full((2, 3), float(step))}}
        mgr.save(step, tree)
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["5", "9"]
    got = mgr.restore()
    assert int(got["step"]) == 9
    assert (got["params"]["post_1"]["kernel"] == 9.0).all()
    back = mgr.restore(tree, step=5)
    assert torch.equal(back["params"]["post_1/kernel"], torch.full((2, 3), 5.))
    with pytest.raises(FileExistsError):
        mgr.save(9, tree)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["5", "9"]
