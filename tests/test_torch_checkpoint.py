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
ITEMS = {"wn_moon": ("step", "params", "ema_params"),
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
    """Every leaf of step, params, ema_params / batch_stats: same dtype,
    shape and bytes as Orbax's StandardCheckpointer restores."""
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
    with pytest.raises(ValueError, match="dict keys"):       # not served
        b.restore(items=("opt_state",))


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
