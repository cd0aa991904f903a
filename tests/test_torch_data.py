"""The port's host data layer (vln_magic_tpu_torch.data) held against
vln_magic_tpu.data on the same files: R2R annotations split per
instruction (``_enc`` files and the tokenizer fallback), RxR's language
filter, the HDF5 and TSV view-feature stores, the object store, the hash
stores and the hash tokenizer bit for bit, and the port's writers read by
JAX's readers.
"""

import json

import numpy as np
import pytest
import torch

from vln_magic_tpu import data as jdata
from vln_magic_tpu.data import features as jfeatures
from vln_magic_tpu_torch import data as tdata
from vln_magic_tpu_torch.data import features as tfeatures

SCAN = "17DRP5sb8fy"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def anno_dir(tmp_path_factory):
    """R2R splits with and without ``_enc`` files and an RxR split in four
    languages."""
    d = tmp_path_factory.mktemp("annotations")
    rng = np.random.default_rng(0)
    for split, enc in (("train", True), ("val_seen", False)):
        items = [{"path_id": 40 + k, "scan": SCAN,
                  "path": [f"vp{k}", f"vp{k + 1}", f"vp{k + 2}"],
                  "heading": 0.25 * k,
                  "instructions": [f"walk past the table {k} {j} ."
                                   for j in range(3)]}
                 for k in range(4)]
        if enc:
            for it in items:
                it["instr_encodings"] = [
                    [0] + rng.integers(4, 900, 40).tolist() + [2]
                    for _ in it["instructions"]]
        name = f"R2R_{split}_enc.json" if enc else f"R2R_{split}.json"
        (d / name).write_text(json.dumps(items))
    langs = ("en-US", "hi-IN", "en-IN", "te-IN")
    with open(d / "RxR_val_unseen_guide_enc_xlmr.jsonl", "w") as f:
        for k in range(8):
            f.write(json.dumps({
                "instruction_id": 700 + k, "scan": SCAN,
                "path": [f"vp{k}", f"vp{k + 3}"], "heading": 0.5,
                "instruction": f"go to room {k}", "language": langs[k % 4],
                "instr_encoding": rng.integers(4, 900, 30).tolist()}) + "\n")
        f.write("\n")
    return str(d)


def _same_items(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("split,max_len,debug", [
    ("train", 200, False), ("train", 16, True), ("val_seen", 200, False)])
def test_r2r_instructions_match_jax(anno_dir, split, max_len, debug):
    """One item per instruction (``instr_id = path_id_j``), encodings from
    the ``_enc`` file or the tokenizer, truncated at ``max_len``."""
    args = (anno_dir, "r2r", [split])
    kw = dict(max_instr_len=max_len, for_debug=debug)
    got = tdata.construct_instrs(*args, tdata.HashTokenizer(900), **kw)
    want = jdata.construct_instrs(*args, jdata.HashTokenizer(900), **kw)
    _same_items(got, want)
    assert [it["instr_id"] for it in got[:3]] == ["40_0", "40_1", "40_2"]


@pytest.mark.parametrize("langs", [("en",), ("hi", "te"), None])
def test_rxr_language_filter_matches_jax(anno_dir, langs):
    got = tdata.construct_instrs(anno_dir, "rxr", ["val_unseen"], langs=langs)
    want = jdata.construct_instrs(anno_dir, "rxr", ["val_unseen"],
                                  langs=langs)
    _same_items(got, want)
    assert len(got) == {("en",): 4, ("hi", "te"): 4, None: 8}[langs]


def test_missing_split_raises_like_jax(anno_dir):
    for module in (tdata, jdata):
        with pytest.raises(FileNotFoundError):
            module.construct_instrs(anno_dir, "r2r", ["test"])


def test_hash_tokenizer_and_stores_match_jax():
    for size in (2000, 50265):
        for text in ("Walk past the TABLE .", "", "a b c d e f"):
            assert tdata.HashTokenizer(size).encode(text) == \
                jdata.HashTokenizer(size).encode(text)
    assert isinstance(tdata.get_tokenizer(None), tdata.HashTokenizer)
    assert isinstance(tdata.get_tokenizer("/no/such/dir"), tdata.HashTokenizer)
    for seed in (0, 1):
        t, j = tdata.HashFeatureStore(24, seed), jdata.HashFeatureStore(24, seed)
        ids = ["vp0", "vp1", "0e92a69a50414253a23043758f111cec"]
        a, b = t.feature_fn()(SCAN, ids), j.feature_fn()(SCAN, ids)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
        t, j = tdata.HashObjectStore(16, seed=seed), \
            jdata.HashObjectStore(16, seed=seed)
        (fa, aa), (fb, ab) = t.get(SCAN, "vp3"), j.get(SCAN, "vp3")
        np.testing.assert_array_equal(fa, fb)
        assert aa["obj_ids"] == ab["obj_ids"]
        np.testing.assert_array_equal(aa["directions"], ab["directions"])
        np.testing.assert_array_equal(aa["sizes"], ab["sizes"])


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(5)
    return {f"{SCAN}_vp{i}": rng.standard_normal((36, 24)).astype(np.float32)
            for i in range(5)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_hdf5_store_matches_jax(tmp_path, feats, writer):
    """The fp16 CLIP layout from either package's writer, read by both
    stores: equal f32 arrays sliced to the width; the port's one open
    handle closes and reopens."""
    pytest.importorskip("h5py")
    path = str(tmp_path / "views.hdf5")
    (tfeatures if writer == "port" else jfeatures).write_hdf5_features(
        path, feats)
    ids = [f"vp{i}" for i in range(5)]
    j = jdata.ImageFeatureStore(path, 16)
    t = tdata.ImageFeatureStore(path, 16)
    first = t.get(SCAN, "vp0")
    np.testing.assert_array_equal(t.feature_fn()(SCAN, ids),
                                  j.feature_fn()(SCAN, ids))
    t.close()
    np.testing.assert_array_equal(
        first, feats[f"{SCAN}_vp0"].astype(np.float16)[:, :16]
        .astype(np.float32))
    assert t._h5 is None                      # closed; the cache stays
    assert t.get(SCAN, "vp0") is first
    np.testing.assert_array_equal(t.get(SCAN, "vp4"), j.get(SCAN, "vp4"))
    t.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tsv_store_matches_jax(tmp_path, feats, writer):
    path = str(tmp_path / "views.tsv")
    (tfeatures if writer == "port" else jfeatures).write_tsv_features(
        path, feats)
    ids = [f"vp{i}" for i in range(5)]
    got = tdata.ImageFeatureStore(path, 20, file_type="tsv").feature_fn()(
        SCAN, ids)
    want = jdata.ImageFeatureStore(path, 20, file_type="tsv").feature_fn()(
        SCAN, ids)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], feats[f"{SCAN}_vp2"][:, :20])


def test_object_store_matches_jax(tmp_path):
    pytest.importorskip("h5py")
    rng = np.random.default_rng(2)
    objs = {f"{SCAN}_vp{i}": (rng.standard_normal((3 + i, 8)),
                              [f"o{i}{k}" for k in range(3 + i)],
                              rng.uniform(-1, 1, (3 + i, 2)),
                              rng.uniform(10, 90, (3 + i, 2)))
            for i in range(3)}
    path = str(tmp_path / "objs.hdf5")
    tfeatures.write_hdf5_object_features(path, objs)
    t = tdata.ObjectFeatureStore(path, 6, max_objects=4)
    j = jdata.ObjectFeatureStore(path, 6, max_objects=4)
    for vp in ("vp0", "vp2", "absent"):
        (fa, aa), (fb, ab) = t.get(SCAN, vp), j.get(SCAN, vp)
        np.testing.assert_array_equal(fa, fb)
        assert aa["obj_ids"] == ab["obj_ids"]
        for k in ("directions", "sizes"):
            np.testing.assert_array_equal(aa[k], ab[k])


def test_lmdb_store_as_jax(tmp_path, feats):
    """With lmdb installed both packages read the port's LMDB file alike;
    without it both raise an ImportError that names the package."""
    try:
        import lmdb  # noqa: F401
    except ImportError:
        for module in (tdata, jdata):
            store = module.ImageFeatureStore(str(tmp_path / "x.lmdb"), 16,
                                             file_type="lmdb")
            with pytest.raises(ImportError, match="lmdb"):
                store.get(SCAN, "vp0")
        return
    path = str(tmp_path / "views.lmdb")
    tfeatures.write_lmdb_features(path, feats)
    t = tdata.ImageFeatureStore(path, 16, file_type="lmdb")
    np.testing.assert_array_equal(
        t.get(SCAN, "vp1"),
        jdata.ImageFeatureStore(path, 16, file_type="lmdb").get(SCAN, "vp1"))
    t.close()
