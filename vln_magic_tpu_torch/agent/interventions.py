"""Causal-intervention tooling: backdoor z-dictionaries and frontdoor CFP
dictionaries (the GOAT lineage carried by MAGIC).

Port of ``vln_magic_tpu/agent/interventions.py``: ``WordPicker``, ``Zdict``
and the reference's base64 TSV layouts, ``update_backdoor_dict`` (the
reference's ``update_z_dict``: the language encoder over every training
instruction, token embeddings mean-pooled per landmark/direction word, p(z)
from the counts), ``build_rollout_zdicts``, ``extract_cfp_features``
(pooled txt/vp/gmap trajectory features) and ``KMeansPicker`` (k-means per
feature family, one exemplar per cluster as the frontdoor dictionary).

``KMeansPicker`` clusters with ``kmeans``, a numpy k-means written to
scikit-learn's ``KMeans(n_clusters, n_init=4, random_state=seed)`` (Lloyd,
k-means++ seeding), so the port gives JAX's dictionaries without
scikit-learn, which the card's machine does not have.
"""

from __future__ import annotations

import base64
import csv
import sys

import numpy as np
import torch

# the reference's direction/action vocabulary (utils/data.py:207-213)
DEFAULT_DIRECTION_WORDS = frozenset(
    "right left down up forward around straight into front behind exit enter "
    "besides through stop out wait passed climb leave past before after "
    "between along back".split())


class WordPicker:
    """Find landmark / direction token positions in instructions."""

    def __init__(self, direction_words=DEFAULT_DIRECTION_WORDS,
                 landmark_words=None, cat_file: str | None = None):
        self.direction_words = set(direction_words)
        self.landmark_words = set(landmark_words or [])
        if cat_file:
            with open(cat_file) as f:
                for r in csv.DictReader(f, delimiter="\t"):
                    name = (r.get("category") or r.get("mpcat40") or "").strip()
                    if name:
                        self.landmark_words.add(name.lower())

    def pick(self, words: list[str]):
        """(landmark_positions, direction_positions) over a word list."""
        lm, dr = [], []
        for i, w in enumerate(words):
            lw = w.lower().strip(".,!?")
            if lw in self.direction_words:
                dr.append(i)
            elif lw in self.landmark_words or (not self.landmark_words
                                               and lw.isalpha() and len(lw) > 3):
                lm.append(i)
        return lm, dr


def _b64(x) -> str:
    return base64.b64encode(np.ascontiguousarray(x, np.float32).tobytes()
                            ).decode("ascii")


def _unb64(blob: str, dim: int) -> np.ndarray:
    return np.frombuffer(base64.b64decode(blob), np.float32)[:dim]


class Zdict:
    """A backdoor dictionary: features [N, D] + priors p(z) [N, 1]."""

    def __init__(self, features: np.ndarray, pzs: np.ndarray,
                 keys: list[str] | None = None):
        self.features = np.asarray(features, np.float32)
        self.pzs = np.asarray(pzs, np.float32).reshape(-1, 1)
        self.keys = keys or [str(i) for i in range(len(self.features))]

    def as_batch(self, batch_size: int, device="cpu"):
        """(features [B, N, D], priors [B, N, 1]) on ``device``, the
        dictionary broadcast over the batch."""
        f = torch.from_numpy(self.features).to(device)
        p = torch.from_numpy(self.pzs).to(device)
        return (f.expand(batch_size, *f.shape),
                p.expand(batch_size, *p.shape))

    # --- base64 TSV persistence (reference LoadZdict, data_utils.py:45-103;
    #     writer agent.py:1306-1351) ---

    def save_tsv(self, path: str):
        with open(path, "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            for key, feat, pz in zip(self.keys, self.features, self.pzs):
                w.writerow([key, float(pz[0]), _b64(feat)])

    @classmethod
    def load_tsv(cls, path: str, dim: int):
        csv.field_size_limit(sys.maxsize)
        keys, feats, pzs = [], [], []
        with open(path) as f:
            for row in csv.reader(f, delimiter="\t"):
                keys.append(row[0])
                pzs.append(float(row[1]))
                feats.append(_unb64(row[2], dim))
        return cls(np.stack(feats), np.asarray(pzs), keys)


@torch.no_grad()
def update_backdoor_dict(navigator, items, picker: WordPicker,
                         batch_size: int = 64, max_entries: int = 81,
                         lang_fn=None):
    """Rebuild the instruction z-dict from the current model (the
    reference's ``update_z_dict``, agent.py:1162-1304).

    Runs the language encoder over ``items`` in batches of ``batch_size``
    on the navigator's device, mean-pools the token embeddings of each
    landmark/direction word (summed on the host in f32, in JAX's order) and
    derives p(z) from the counts.  Returns ``{'direction': Zdict,
    'landmark': Zdict}``.  ``navigator`` needs ``model`` and ``cfg``;
    ``lang_fn(ids, mask)`` replaces ``navigator.model.language`` (the
    trainer's, under its autocast)."""
    from .navigator import pad_instructions

    model = navigator.model
    device = next(model.parameters()).device
    lang = lang_fn or (lambda ids, mask: model.language(ids, mask))
    sums = {"landmark": {}, "direction": {}}
    counts = {"landmark": {}, "direction": {}}
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        txt_ids, txt_masks = pad_instructions(
            chunk, navigator.cfg.env.max_instr_len)
        embeds, _ = lang(torch.from_numpy(txt_ids).to(device),
                         torch.from_numpy(txt_masks).to(device))
        embeds = embeds.float().cpu().numpy()
        for b, it in enumerate(chunk):
            words = it["instruction"].split()
            lm, dr = picker.pick(words)
            # +1 for the BOS token offset in the encoding
            for kind, positions in (("landmark", lm), ("direction", dr)):
                for pos in positions:
                    tpos = pos + 1
                    if tpos >= txt_masks.shape[1] or not txt_masks[b, tpos]:
                        continue
                    w = words[pos].lower().strip(".,!?")
                    sums[kind][w] = sums[kind].get(w, 0.0) + embeds[b, tpos]
                    counts[kind][w] = counts[kind].get(w, 0) + 1

    out = {}
    for kind in ("landmark", "direction"):
        ws = sorted(counts[kind], key=counts[kind].get, reverse=True)
        ws = ws[:max_entries]
        if not ws:
            d = navigator.cfg.model.hidden_size
            out[kind] = Zdict(np.zeros((1, d), np.float32), np.ones((1, 1)))
            continue
        total = sum(counts[kind][w] for w in ws)
        feats = np.stack([sums[kind][w] / counts[kind][w] for w in ws])
        pzs = np.array([counts[kind][w] / total for w in ws])
        out[kind] = Zdict(feats, pzs, ws)
    return out


def save_backdoor_tsv(path: str, dicts: dict):
    """Persist {'direction': Zdict, 'landmark': Zdict} to one TSV with
    kind-prefixed keys ("direction:left") in the reference row layout
    (key, p(z), base64 float32 features)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for kind, z in dicts.items():
            for key, feat, pz in zip(z.keys, z.features, z.pzs):
                w.writerow([f"{kind}:{key}", float(pz[0]), _b64(feat)])


def load_backdoor_tsv(path: str, dim: int):
    """Load a backdoor z-dict TSV (``--*_backdoor_dict_file``): the
    kind-prefixed layout of ``save_backdoor_tsv``; rows without a kind
    prefix (reference-written dicts) are classified by the direction-word
    list, the rest landing in 'landmark'."""
    csv.field_size_limit(sys.maxsize)
    rows = {"direction": ([], [], []), "landmark": ([], [], [])}
    with open(path) as f:
        for row in csv.reader(f, delimiter="\t"):
            key, pz, blob = row[0], float(row[1]), row[2]
            if ":" in key and key.split(":", 1)[0] in rows:
                kind, key = key.split(":", 1)
            else:
                kind = ("direction" if key.lower() in DEFAULT_DIRECTION_WORDS
                        else "landmark")
            ks, ps, fs = rows[kind]
            ks.append(key)
            ps.append(pz)
            fs.append(_unb64(blob, dim))
    out = {}
    for kind, (ks, ps, fs) in rows.items():
        if not fs:
            out[kind] = Zdict(np.zeros((1, dim), np.float32),
                              np.ones((1, 1)))
            continue
        out[kind] = Zdict(np.stack(fs), np.asarray(ps), ks)
    return out


def build_rollout_zdicts(backdoor=None, front=None, pad_entries: int = 0,
                         img: Zdict | None = None):
    """One role's backdoor Zdicts + frontdoor family features in the
    structure ``Rollout.run(zdicts={role: ...})`` takes (numpy arrays,
    without the batch axis).  ``pad_entries`` pads the instruction's
    backdoor tables to a fixed row count with p(z) = 0 rows, which the
    model's log-prior bias suppresses (``models.vlnbert.ZdictAttention``).
    ``img``: the image backdoor's dictionary at ``image_feat_size``
    (``z_img_feats``, ``z_img_pzs``), as it is, unpadded."""
    out = {}
    if backdoor:
        def padded(z: Zdict):
            f, p = z.features, z.pzs
            if pad_entries and len(f) < pad_entries:
                extra = pad_entries - len(f)
                f = np.concatenate(
                    [f, np.zeros((extra, f.shape[1]), np.float32)])
                p = np.concatenate([p, np.zeros((extra, 1), np.float32)])
            return f[:pad_entries or None], p[:pad_entries or None]

        dzf, dzp = padded(backdoor["direction"])
        lzf, lzp = padded(backdoor["landmark"])
        out["instr_zdict"] = {
            "direction_features": dzf, "direction_pzs": dzp,
            "landmark_features": lzf, "landmark_pzs": lzp,
        }
    if front:
        out["front_txt_feats"] = front["txt"]
        out["front_vp_feats"] = front["vp"]
        out["front_gmap_feats"] = front["gmap"]
    if img is not None:
        out["z_img_feats"], out["z_img_pzs"] = img.features, img.pzs
    return out


def zdicts_on(z: dict | None, batch_size: int | None, device) -> dict:
    """One role's rollout z-dicts (``build_rollout_zdicts``; numpy arrays
    or tensors) as f32 tensors on ``device``, each broadcast over
    ``batch_size`` (JAX's ``zd_for``; ``None``: no batch axis added);
    ``None`` entries dropped.  Tensors already there are not copied."""
    out = {}
    for k, v in (z or {}).items():
        if v is None:
            continue
        if isinstance(v, dict):
            out[k] = zdicts_on(v, batch_size, device)
            continue
        t = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v, np.float32)))
        t = t.to(device=device, dtype=torch.float32)
        out[k] = t if batch_size is None else t.expand(batch_size, *t.shape)
    return out


def flat_zdicts(zd: dict, prefix: str = "") -> dict:
    """Rollout z-dicts (nested one level; numpy arrays or tensors) as
    ``{"instr_zdict.direction_features": array, ...}``: the layout of a
    serving bundle's ``zdicts.npz``."""
    out = {}
    for k, v in zd.items():
        if isinstance(v, dict):
            out.update(flat_zdicts(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def nested_zdicts(flat: dict) -> dict:
    """The inverse of ``flat_zdicts``."""
    out = {}
    for name, v in flat.items():
        head, _, leaf = name.rpartition(".")
        (out.setdefault(head, {}) if head else out)[leaf] = v
    return out


@torch.no_grad()
def extract_cfp_features(navigator, items, builder, batch_size: int = 32,
                         autocast=None):
    """Pooled txt/vp/gmap features per trajectory through the model's
    ``language`` → ``panorama`` → ``navigation`` → ``extract_cfp`` on
    ``builder.cfp_batch`` (agent.py:1516-1561), in batches of
    ``batch_size``.  Returns ({family: [N, D] f32}, instruction ids).
    ``autocast``: a context factory to run the forwards in (the trainer's
    bf16 autocast)."""
    from contextlib import nullcontext

    model = navigator.model
    device = next(model.parameters()).device
    ctx = autocast or nullcontext
    fams = {"txt": [], "gmap": [], "vp": []}
    ids = []
    for i in range(0, len(items), batch_size):
        chunk = items[i : i + batch_size]
        batch = {k: torch.from_numpy(np.asarray(v)).to(device)
                 for k, v in builder.cfp_batch(chunk).items()}
        with ctx():
            out = _cfp_forward(model, batch)
        for k in fams:
            fams[k].append(out[k].float().cpu().numpy())
        ids.extend(it["instr_id"] for it in chunk)
    return {k: np.concatenate(v) for k, v in fams.items()}, ids


def _cfp_forward(model, batch):
    long = lambda k: batch[k].long()
    txt_embeds, _ = model.language(long("txt_ids"), batch["txt_masks"])
    b, s = batch["traj_view_fts"].shape[:2]
    fold = lambda k: batch[k].reshape((b * s,) + batch[k].shape[2:])
    pano_embeds, pano_fused, _ = model.panorama(
        fold("traj_view_fts"), fold("traj_loc_fts"),
        fold("traj_nav_types").long(), fold("traj_pano_masks"))
    pano_embeds = pano_embeds.reshape((b, s) + pano_embeds.shape[1:])
    pano_fused = pano_fused.reshape(b, s, -1)
    src_step, slot = long("gmap_src_step"), long("gmap_src_slot")
    step = src_step.clamp(min=0)
    bi = torch.arange(b, device=step.device)[:, None]
    gmap_img = torch.where((slot >= 0)[..., None],
                           pano_embeds[bi, step, slot.clamp(min=0)],
                           pano_fused[bi, step])
    gmap_img = gmap_img * (src_step >= 0)[..., None]
    last_pano = pano_embeds[torch.arange(b, device=step.device),
                            long("final_step")]
    vp_img = torch.cat([last_pano.new_zeros((b, 2, last_pano.shape[-1])),
                        last_pano], 1)
    outs = model.navigation(
        txt_embeds, batch["txt_masks"], gmap_img, long("gmap_step_ids"),
        batch["gmap_pos_fts"], batch["gmap_masks"],
        batch["gmap_visited_masks"], batch["gmap_pair_dists"], vp_img,
        batch["vp_pos_fts"], batch["vp_masks"], batch["vp_nav_masks"],
        long("gmap_local_slot"), batch["vp_cand_visited"])
    return model.extract_cfp(txt_embeds, outs["gmap_embeds"],
                             outs["vp_embeds"])


def save_cfp_tsv(path: str, features: dict, ids):
    """The reference cfp_features_{iter}.tsv layout (agent.py:1549-1561)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        for i, instr_id in enumerate(ids):
            w.writerow([instr_id] + [_b64(features[k][i])
                                     for k in ("txt", "gmap", "vp")])


def load_cfp_tsv(path: str, dim: int):
    csv.field_size_limit(sys.maxsize)
    ids, fams = [], {"txt": [], "gmap": [], "vp": []}
    with open(path) as f:
        for row in csv.reader(f, delimiter="\t"):
            ids.append(row[0])
            for j, k in enumerate(("txt", "gmap", "vp")):
                fams[k].append(_unb64(row[1 + j], dim))
    return {k: np.stack(v) for k, v in fams.items()}, ids


# ---- k-means (scikit-learn's KMeans, Lloyd with k-means++ seeding) -------

_CHUNK = 256        # sklearn's CHUNK_SIZE: samples per distance block


def _sq_dists_f64(a, x, x_sq):
    """sklearn's ``_euclidean_distances(..., squared=True)`` of float32
    input: ‖a‖² − 2a·x + ‖x‖² upcast to f64, cast back, clipped at 0."""
    a64 = a.astype(np.float64)
    d = -2 * (a64 @ x.T) + np.einsum("ij,ij->i", a64, a64)[:, None] + x_sq
    return np.maximum(d.astype(np.float32), 0)


def _kmeans_plusplus(x, k, rs):
    """k-means++ seeding with ``2 + int(log k)`` local trials, drawing from
    ``rs`` exactly as sklearn's ``_kmeans_plusplus`` does."""
    n = x.shape[0]
    w = np.ones(n, x.dtype)
    x64 = x.astype(np.float64)
    x_sq = np.einsum("ij,ij->i", x64, x64)[None, :]
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    first = rs.choice(n, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_dists_f64(x64[first][None], x64, x_sq)
    pot = closest @ w
    closest = closest[0]
    pot = pot[0]
    for c in range(1, k):
        vals = rs.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = _sq_dists_f64(x64[cand], x64, x_sq)
        np.minimum(closest, d, out=d)
        pots = d @ w.reshape(-1, 1)
        best = np.argmin(pots)
        pot, closest = pots[best], d[best]
        centers[c] = x[cand[best]]
    return centers


def _lloyd_step(x, centers, update=True):
    """One E-step (labels: argmin of ‖c‖² − 2x·c in f32, first on a tie)
    and, with ``update``, the M-step: f32 sums in sample order (sklearn's
    on one thread), an empty cluster relocated to the point farthest from
    its center, the means and each center's shift."""
    k = centers.shape[0]
    c_sq = np.einsum("ij,ij->i", centers, centers)
    labels = np.empty(x.shape[0], np.int32)
    for s in range(0, x.shape[0], _CHUNK):
        d = c_sq[None, :] + np.float32(-2.0) * (x[s : s + _CHUNK] @ centers.T)
        labels[s : s + _CHUNK] = np.argmin(d, axis=1)
    if not update:
        return labels, None, None
    new = np.zeros_like(centers)
    np.add.at(new, labels, x)
    weight = np.bincount(labels, minlength=k).astype(x.dtype)
    empty = np.flatnonzero(weight == 0).astype(np.int32)
    if len(empty):
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
        if np.max(dist) != 0:
            for new_id, far_idx in zip(empty, far):
                old_id = labels[far_idx]
                new[old_id] -= x[far_idx]
                new[new_id] = x[far_idx]
                weight[new_id] = 1
                weight[old_id] -= 1
    heavy = np.argmax(weight)
    for j in range(k):
        if weight[j] > 0:
            new[j] *= np.float32(1.0) / weight[j]
        else:
            new[j] = new[heavy]
    shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
    return labels, new, shift


def _same_clustering(a, b, k) -> bool:
    """sklearn's ``_is_same_clustering``: equal partitions up to a
    relabelling."""
    mapping = np.full(k, -1, np.int64)
    for i, j in zip(a, b):
        if mapping[i] == -1:
            mapping[i] = j
        elif mapping[i] != j:
            return False
    return True


def kmeans(x, n_clusters: int, n_init: int = 4, seed: int = 0,
           max_iter: int = 300, tol: float = 1e-4):
    """scikit-learn's ``KMeans(n_clusters, n_init=n_init,
    random_state=seed).fit(x)`` in numpy: (labels [N] int32, centers [k,
    D]).  The data are centred; each of the ``n_init`` runs seeds with
    k-means++ from one shared ``RandomState(seed)`` and runs Lloyd until
    the labels repeat or the squared center shift falls to ``tol`` × the
    mean feature variance, then a final E-step; the run of least inertia
    wins unless it partitions as the best so far."""
    x = np.array(x, np.float32, order="C")
    rs = np.random.RandomState(seed)
    tol_abs = np.mean(np.var(x, axis=0)) * tol
    mean = x.mean(axis=0)
    x = x - mean
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(x, n_clusters, rs)
        old = np.full(x.shape[0], -1, np.int32)
        strict = False
        for _ in range(max_iter):
            labels, centers_new, shift = _lloyd_step(x, centers)
            centers = centers_new
            if np.array_equal(labels, old):
                strict = True
                break
            if (shift ** 2).sum() <= tol_abs:
                break
            old = labels
        if not strict:
            labels, _, _ = _lloyd_step(x, centers, update=False)
        inertia = ((x - centers[labels]) ** 2).sum(axis=1).sum()
        if best is None or (inertia < best[0] and not _same_clustering(
                labels, best[1], n_clusters)):
            best = (inertia, labels, centers)
    return best[1], best[2] + mean


class KMeansPicker:
    """Frontdoor dictionary builder (utils/data.py:436-512): k-means per
    family (``kmeans``, scikit-learn's ``KMeans(n_clusters=min(k, N),
    n_init=4, random_state=seed)``), one random exemplar per cluster on
    each pick."""

    def __init__(self, features: dict, n_clusters: int = 24, seed: int = 0):
        self.features = features
        self.n_clusters = n_clusters
        self.k = {}
        self.assignments = {}
        for name, x in features.items():
            self.k[name] = min(n_clusters, len(x))
            self.assignments[name], _ = kmeans(x, self.k[name], seed=seed)

    def random_pick_front_features(self, rng: np.random.Generator):
        """{family: [n_clusters, D]}: one sampled exemplar per cluster."""
        out = {}
        for name, x in self.features.items():
            labels = self.assignments[name]
            rows = []
            for c in range(self.k[name]):
                idx = np.flatnonzero(labels == c)
                rows.append(x[rng.choice(idx)] if len(idx)
                            else np.zeros(x.shape[1], np.float32))
            out[name] = np.stack(rows)
        return out
