"""View-feature stores: HDF5 / base64-TSV readers with an in-RAM cache, plus
the deterministic hash store used when no dataset is mounted.

Equivalent of the reference's ImageFeaturesDB (reference:
map_nav_src/utils/data.py:28-77).  The TPU-first difference: features are
read once at world build and baked into the device feature table
(env/world.py) — per-step reads never touch the host.

A copy of ``vln_magic_tpu/data/features.py``.  ``h5py``, ``lmdb`` and
``msgpack`` are imported inside the functions that read or write those
formats.  One difference: ``ImageFeatureStore`` opens an HDF5 file once and
keeps the handle until ``close()`` (JAX's opens it for every viewpoint,
about 10.5k opens for R2R's 90 scans); the arrays are the same.
"""

from __future__ import annotations

import base64
import csv
import sys

import numpy as np


class ImageFeatureStore:
    """HDF5 (key "{scan}_{vp}" -> (36, D)) or TSV-backed store."""

    def __init__(self, path: str, image_feat_size: int, file_type: str = "hdf5"):
        self.path = path
        self.dim = image_feat_size
        self.file_type = file_type
        self._cache = {}
        self._tsv_loaded = False
        self._h5 = None

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        key = f"{scan}_{viewpoint}"
        if key in self._cache:
            return self._cache[key]
        if self.file_type == "hdf5":
            ft = self._hdf5()[key][...][:, : self.dim].astype(np.float32)
            self._cache[key] = ft
            return ft
        if self.file_type == "lmdb":
            ft = self._lmdb_get(key)
            self._cache[key] = ft
            return ft
        self._load_tsv()
        return self._cache[key]

    def _hdf5(self):
        """The HDF5 file, opened read-only at the first read."""
        if self._h5 is None:
            import h5py

            self._h5 = h5py.File(self.path, "r")
        return self._h5

    def close(self):
        """Close the HDF5 file or LMDB environment, if one is open; the
        cached arrays stay readable."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        env = self.__dict__.pop("_lmdb_env", None)
        if env is not None:
            env.close()

    def _lmdb_get(self, key: str) -> np.ndarray:
        """LMDB-backed read (the reference's third reader family,
        pretrain_src/data/dataset.py:818-884: msgpack-encoded arrays keyed by
        scan_vp).  Gated on the ``lmdb`` package being importable."""
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "file_type='lmdb' needs the lmdb package; re-export the "
                "features to HDF5/TSV or install lmdb") from e
        import msgpack

        if not hasattr(self, "_lmdb_env"):
            self._lmdb_env = lmdb.open(self.path, readonly=True, lock=False)
        with self._lmdb_env.begin() as txn:
            raw = txn.get(key.encode("ascii"))
            if raw is None:
                raise KeyError(key)
            blob = msgpack.unpackb(raw, raw=False)
            arr = np.frombuffer(
                blob["data"], dtype=np.dtype(blob["dtype"])).reshape(
                blob["shape"])
        return np.asarray(arr[:, : self.dim], np.float32)

    def _load_tsv(self):
        if self._tsv_loaded:
            return
        csv.field_size_limit(sys.maxsize)
        fields = ["scanId", "viewpointId", "image_w", "image_h", "vfov",
                  "features"]
        with open(self.path) as f:
            for row in csv.DictReader(f, delimiter="\t", fieldnames=fields):
                ft = np.frombuffer(
                    base64.b64decode(row["features"]), dtype=np.float32
                ).reshape(36, -1)[:, : self.dim]
                self._cache[f"{row['scanId']}_{row['viewpointId']}"] = ft
        self._tsv_loaded = True

    def feature_fn(self):
        """Bulk reader for World construction."""
        def fn(scan, node_ids):
            return np.stack([self.get(scan, vp) for vp in node_ids])
        return fn


class HashFeatureStore:
    """Deterministic pseudo-features for dataset-free runs (the framework's
    synthetic fallback; the reference has no equivalent — SURVEY §4)."""

    def __init__(self, image_feat_size: int, seed: int = 0):
        self.dim = image_feat_size
        self.seed = seed

    def get(self, scan: str, viewpoint: str) -> np.ndarray:
        import zlib

        h = zlib.crc32(f"{scan}|{viewpoint}|{self.seed}".encode()) & 0x7FFFFFFF
        r = np.random.default_rng(h)
        return r.standard_normal((36, self.dim)).astype(np.float32) * 0.5

    def feature_fn(self):
        def fn(scan, node_ids):
            return np.stack([self.get(scan, vp) for vp in node_ids])
        return fn


class ObjectFeatureStore:
    """REVERIE object-feature store: ``get(scan, vp) -> (fts, attrs)`` where
    ``fts`` is [n_obj, obj_feat(+prob)] and ``attrs`` carries ``obj_ids``
    (strings), ``directions`` [n, 2] (heading/elevation) and ``sizes``
    [n, 2] (w, h in pixels).

    Counterpart of the reference's object store (reference:
    pretrain_src/data/dataset.py:224-244 get_scanvp_feature obj branch,
    :845-884 load_obj_feats: LMDB msgpack records with fts / centers /
    bboxes / obj_ids).  Supports the reference LMDB layout and an HDF5
    layout (dataset per key, attrs on the dataset).
    """

    def __init__(self, path: str, obj_feat_size: int, max_objects: int = 20,
                 file_type: str = "hdf5"):
        self.path = path
        self.dim = obj_feat_size
        self.max_objects = max_objects
        self.file_type = file_type
        self._cache = {}

    def get(self, scan: str, viewpoint: str):
        key = f"{scan}_{viewpoint}"
        if key in self._cache:
            return self._cache[key]
        empty = (np.zeros((0, self.dim), np.float32),
                 {"obj_ids": [], "directions": np.zeros((0, 2), np.float32),
                  "sizes": np.zeros((0, 2), np.float32)})
        if self.file_type == "hdf5":
            import h5py

            with h5py.File(self.path, "r") as f:
                if key not in f:
                    out = empty
                else:
                    ds = f[key]
                    m = self.max_objects
                    fts = ds[...][:m, : self.dim].astype(np.float32)
                    attrs = {
                        "obj_ids": [x.decode() if isinstance(x, bytes)
                                    else str(x) for x in
                                    np.asarray(ds.attrs["obj_ids"])[:m]],
                        "directions": np.asarray(
                            ds.attrs.get("centers",
                                         np.zeros((len(fts), 2))),
                            np.float32)[:m],
                        "sizes": self._sizes_from(ds.attrs, len(fts)),
                    }
                    out = (fts, attrs)
        elif self.file_type == "lmdb":
            out = self._lmdb_get(key, empty)
        else:
            raise ValueError(self.file_type)
        self._cache[key] = out
        return out

    def _sizes_from(self, attrs, n):
        if "sizes" in attrs:
            return np.asarray(attrs["sizes"], np.float32)[: self.max_objects]
        if "bboxes" in attrs:
            bb = np.asarray(attrs["bboxes"], np.float32)[: self.max_objects]
            # bbox -> (w, h), the reference derivation (dataset.py:963-966)
            return np.stack([bb[:, 2] - bb[:, 0], bb[:, 3] - bb[:, 1]], 1)
        return np.zeros((n, 2), np.float32)

    def _lmdb_get(self, key, empty):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "file_type='lmdb' needs the lmdb package; re-export the "
                "object features to HDF5") from e
        import msgpack

        if not hasattr(self, "_lmdb_env"):
            self._lmdb_env = lmdb.open(self.path, readonly=True, lock=False)
        with self._lmdb_env.begin() as txn:
            raw = txn.get(key.encode("ascii"))
        if raw is None:
            return empty
        d = msgpack.unpackb(raw, raw=False)
        m = self.max_objects
        fts = np.asarray(d["fts"], np.float32)[:m, : self.dim]
        attrs = {
            "obj_ids": [str(x) for x in d.get("obj_ids", [])[:m]],
            "directions": np.asarray(
                d.get("centers", np.zeros((len(fts), 2))), np.float32)[:m],
            "sizes": self._sizes_from(d, len(fts)),
        }
        return fts, attrs


class HashObjectStore:
    """Deterministic pseudo-objects for dataset-free REVERIE runs (same role
    as HashFeatureStore: SURVEY §4's synthetic backend)."""

    def __init__(self, obj_feat_size: int, max_objects: int = 20,
                 seed: int = 0, min_objects: int = 2):
        self.dim = obj_feat_size
        self.max_objects = max_objects
        self.min_objects = min_objects
        self.seed = seed

    def get(self, scan: str, viewpoint: str):
        import zlib

        h = zlib.crc32(f"obj|{scan}|{viewpoint}|{self.seed}".encode()) & 0x7FFFFFFF
        r = np.random.default_rng(h)
        n = int(r.integers(self.min_objects, self.max_objects + 1))
        fts = r.standard_normal((n, self.dim)).astype(np.float32) * 0.5
        attrs = {
            "obj_ids": [str(int(x)) for x in r.integers(0, 10000, n)],
            "directions": r.uniform(-np.pi, np.pi, (n, 2)).astype(np.float32),
            "sizes": r.uniform(20, 400, (n, 2)).astype(np.float32),
        }
        return fts, attrs


def write_hdf5_object_features(path: str, objs: dict):
    """Writer for the HDF5 object layout (test fixtures): ``objs`` maps
    "{scan}_{vp}" -> (fts [n, d], obj_ids list[str], centers [n, 2],
    sizes [n, 2])."""
    import h5py

    with h5py.File(path, "w") as f:
        for key, (fts, obj_ids, centers, sizes) in objs.items():
            ds = f.create_dataset(key, data=np.asarray(fts, np.float32))
            ds.attrs["obj_ids"] = np.asarray(obj_ids, dtype="S")
            ds.attrs["centers"] = np.asarray(centers, np.float32)
            ds.attrs["sizes"] = np.asarray(sizes, np.float32)


def write_hdf5_features(path: str, feats: dict[str, np.ndarray],
                        dtype=np.float16):
    """Writer for the real ``CLIP-ViT-B-16-views.hdf5`` layout (test
    fixtures): key "{scan}_{vp}" -> [36, D].  The released files store fp16;
    readers slice ``[:, :dim]`` and cast to f32 (reference
    utils/data.py:46-49)."""
    import h5py

    with h5py.File(path, "w") as f:
        for key, ft in feats.items():
            f.create_dataset(key, data=np.asarray(ft, dtype))


def write_lmdb_features(path: str, feats: dict[str, np.ndarray]):
    """msgpack-encoded LMDB twin of the view-feature store (the reference's
    third reader family, pretrain_src/data/dataset.py:818-884)."""
    import lmdb
    import msgpack

    env = lmdb.open(path, map_size=1 << 28)
    with env.begin(write=True) as txn:
        for key, ft in feats.items():
            ft = np.ascontiguousarray(ft, np.float32)
            txn.put(key.encode("ascii"), msgpack.packb(
                {"data": ft.tobytes(), "dtype": str(ft.dtype),
                 "shape": list(ft.shape)}, use_bin_type=True))
    env.close()


def write_tsv_features(path: str, feats: dict[str, np.ndarray]):
    """Writer for the reference TSV layout (test fixtures + CFP exports)."""
    fields = ["scanId", "viewpointId", "image_w", "image_h", "vfov", "features"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, delimiter="\t", fieldnames=fields)
        for key, ft in feats.items():
            scan, vp = key.split("_", 1)
            w.writerow({
                "scanId": scan, "viewpointId": vp, "image_w": 640,
                "image_h": 480, "vfov": 60,
                "features": base64.b64encode(
                    np.ascontiguousarray(ft, dtype=np.float32).tobytes()
                ).decode("ascii"),
            })
