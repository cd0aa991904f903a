"""Proxy-task data assembly: trajectory batches + MLM/MRC/SAP/CFP inputs.

Host-side counterpart of the reference's ReverieTextPathData /
R2RTextPathData + task datasets (reference: pretrain_src/data/dataset.py:137-
786, tasks.py:11-678), rebuilt against the world tables: fixed-shape padded
batches, identical token layouts to the navigator rollout ([stop],[mem],
visited...,frontier... gmap; [stop],[mem],cands...,views... panorama) so
pretrained weights transfer exactly.

This is the data layer (cold path) — plain numpy, one pass per batch; the
model consumes the result entirely on device.

A copy of ``vln_magic_tpu/pretrain/tasks.py`` over the port's own copies of
``env.geometry`` and ``env.world``: the same world, items and seed give the
same batches bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..env.geometry import get_angle_fts, gmap_pos_features, ALL_VIEW_ANGLES
from ..env.world import World

TRAIN_MAX_STEP = 20   # truncation (reference dataset.py:377, env.py:24)


def mlm_mask(tokens: np.ndarray, rng: np.random.Generator, mask_token: int,
             vocab_size: int, mask_prob: float = 0.15,
             special_ids=(0, 1, 2)):
    """BERT 15% / 80-10-10 masking (reference pretrain_src/data/tasks.py:
    11-52).  Returns (masked_tokens, labels) with -100 on unmasked."""
    tokens = tokens.copy()
    labels = np.full_like(tokens, -100)
    maskable = ~np.isin(tokens, special_ids)
    sel = (rng.random(tokens.shape) < mask_prob) & maskable
    if not sel.any():    # always mask at least one position
        idx = np.flatnonzero(maskable.reshape(-1))
        if len(idx):
            sel.reshape(-1)[rng.choice(idx)] = True
    labels[sel] = tokens[sel]
    roll = rng.random(tokens.shape)
    tokens[sel & (roll < 0.8)] = mask_token
    rand = sel & (roll >= 0.8) & (roll < 0.9)
    tokens[rand] = rng.integers(4, vocab_size, rand.sum())
    return tokens, labels


class PathDataBuilder:
    """Builds fixed-shape pretraining batches from (world, items)."""

    def __init__(self, world: World, max_steps: int = 8, max_gmap: int = 48,
                 max_txt: int = 64, angle_feat_size: int = 4,
                 image_prob_size: int = 1000, mask_token: int = 3,
                 vocab_size: int = 50265, seed: int = 0, aug_features=None,
                 obj_db=None, max_objects: int = 20):
        self.world = world
        self.t = world.tables
        self.S = max_steps
        self.G = max_gmap
        self.L = max_txt
        self.afs = angle_feat_size
        self.prob_size = image_prob_size
        self.mask_token = mask_token
        self.vocab_size = vocab_size
        self.rng = np.random.default_rng(seed)
        self.P = self.t.max_candidates + 36
        # EnvEdit-augmented feature table, same layout as tables.features;
        # when set, every per-viewpoint feature fetch coin-flips between the
        # original and augmented features (reference dataset.py:230-237,
        # get_scanvp_feature: np.random.rand() > 0.5 per fetch)
        self.aug_features = aug_features
        # REVERIE object store (ObjectFeatureStore / HashObjectStore):
        # og_batch ingests real endpoint objects when set
        self.obj_db = obj_db
        self.max_objects = max_objects
        # object-image box normalization: REVERIE frames are 640x480
        # (reference dataset.py:489-491); the SOON variant uses 600x600
        # (SoonTextPathData, dataset.py:796-797) — set by soon_mode
        self.obj_image_wh = (640.0, 480.0)

    def soon_mode(self):
        """Switch to SOON-dataset semantics (reference SoonTextPathData,
        pretrain_src/data/dataset.py:775-816): 600x600 object images, 'pos'
        endpoints are the annotated gt path end (no pos_vps resampling), and
        object labels come from ``obj_pseudo_label`` (see og_batch)."""
        self.obj_image_wh = (600.0, 600.0)
        self._soon = True
        return self

    # ----- per-item assembly -----

    def _headings_along(self, si, path):
        """Arrival heading/elevation per step (get_cur_angle semantics,
        reference env.py:237-247)."""
        t = self.t
        hs, es = [0.0], [0.0]
        for prev, cur in zip(path[:-1], path[1:]):
            cands = t.cand_ids[si, prev]
            j = int(np.argmax(cands == cur))
            view = int(t.cand_view[si, prev, j]) if cands[j] == cur else 12
            hs.append((view % 12) * np.pi / 6)
            es.append((view // 12 - 1) * np.pi / 6)
        return np.array(hs), np.array(es)

    def _pano_step(self, si, node, heading, elevation):
        t = self.t
        C = t.max_candidates
        cand_mask = t.cand_mask[si, node]
        cand_view = t.cand_view[si, node]
        # EnvEdit coin-flip per feature fetch (dataset.py get_scanvp_feature)
        if self.aug_features is not None and self.rng.random() > 0.5:
            feats36 = np.asarray(self.aug_features[si, node], np.float32)
        else:
            feats36 = np.asarray(t.features[si, node], np.float32)
        cand_feat = feats36[cand_view]
        cand_ang = get_angle_fts(t.cand_heading[si, node] - heading,
                                 t.cand_elevation[si, node] - elevation,
                                 self.afs)
        view_ang = get_angle_fts(ALL_VIEW_ANGLES[:, 0] - heading,
                                 ALL_VIEW_ANGLES[:, 1] - elevation, self.afs)
        used = np.zeros(36, bool)
        used[cand_view[cand_mask]] = True
        view_fts = np.concatenate([cand_feat, feats36], 0)
        ang = np.concatenate([cand_ang, view_ang], 0)
        loc = np.concatenate([ang, np.ones((self.P, 3), np.float32)], 1)
        pano_mask = np.concatenate([cand_mask, ~used])
        nav_types = np.concatenate([cand_mask.astype(np.int32),
                                    np.zeros(36, np.int32)])
        return view_fts, loc, nav_types, pano_mask

    def sample_endpoint(self, item, end_vp_type: str):
        """Endpoint sampling per ``end_vp_type`` (reference dataset.py
        get_input: ReverieTextPathData :359-372, R2RTextPathData :650-658).

        Returns (path, end_step, pos_set):
          pos             — a true endpoint: the gt path end (R2R) or a
                            sampled ``pos_vps`` viewpoint with a
                            shortest-path trajectory (REVERIE);
          neg_in_gt_path  — a non-endpoint node on the gt path (uniform);
          neg_others      — REVERIE: an off-path reachable node with a
                            shortest-path trajectory; R2R collapses this to
                            neg_in_gt_path (the R2R get_input override).
        """
        si = item["scan_idx"]
        gt = [int(v) for v in np.asarray(item["path_idx"])]
        reverie = "pos_vps_idx" in item
        pos = ([int(v) for v in item["pos_vps_idx"]] if reverie else [gt[-1]])
        if end_vp_type == "pos":
            # SOON keeps REVERIE's pos_vps for negatives but pins 'pos' to
            # the annotated path end (SoonTextPathData.get_input,
            # dataset.py:803-816)
            if reverie and not getattr(self, "_soon", False):
                end_vp = int(self.rng.choice(pos))
                path = [int(v) for v in
                        self.world.graphs[si].path_indices(gt[0], end_vp)]
                return path, len(path) - 1, set(pos)
            return gt, len(gt) - 1, set(pos)
        if end_vp_type == "neg_in_gt_path" or not reverie:
            cands = [i for i in range(len(gt) - 1) if gt[i] not in pos] \
                or list(range(max(len(gt) - 1, 1)))
            return gt, int(self.rng.choice(cands)), set(pos)
        # neg_others, REVERIE: reachable node off the gt path / pos set
        t = self.t
        reach = np.flatnonzero(
            np.asarray(t.node_mask[si]) & (np.asarray(t.dist[si, gt[0]]) < 1e8))
        excl = set(gt) | set(pos)
        options = [int(n) for n in reach if int(n) not in excl] or gt[:-1]
        end_vp = int(self.rng.choice(options))
        path = [int(v) for v in
                self.world.graphs[si].path_indices(gt[0], end_vp)]
        return path, len(path) - 1, set(pos)

    def build_item(self, item, end_step=None, end_vp_type=None):
        """Assemble one partial-path sample.  ``end_vp_type`` invokes the
        reference endpoint-sampling scheme (see :meth:`sample_endpoint`);
        otherwise the trajectory ends at ``end_step`` (uniform when None)."""
        si = item["scan_idx"]
        t = self.t
        if end_vp_type is not None:
            path, end_step, pos_set = self.sample_endpoint(item, end_vp_type)
            path = path[:TRAIN_MAX_STEP]
        else:
            path = [int(v) for v in np.asarray(item["path_idx"])][:TRAIN_MAX_STEP]
            pos_set = {path[-1]}
        k = len(path)
        if end_step is None:
            end_step = int(self.rng.integers(0, k))
        end_step = min(end_step, self.S - 1, k - 1)
        visited = path[: end_step + 1]
        hs, es = self._headings_along(si, visited)
        cur = visited[-1]
        cur_h, cur_e = hs[-1], es[-1]

        S, P, G = self.S, self.P, self.G
        feat_dim = t.feat_dim
        view_fts = np.zeros((S, P, feat_dim), np.float32)
        loc_fts = np.zeros((S, P, 4 + 3), np.float32)
        nav_types = np.zeros((S, P), np.int32)
        pano_masks = np.zeros((S, P), bool)
        traj_mask = np.zeros((S,), bool)

        # gmap bookkeeping: first-observation order along the walk
        order = {}          # node -> (src_step, src_slot)
        for s, node in enumerate(visited):
            v, l, nt, pm = self._pano_step(si, node, hs[s], es[s])
            view_fts[s], loc_fts[s], nav_types[s], pano_masks[s] = v, l, nt, pm
            traj_mask[s] = True
            if node not in order:
                order[node] = (s, -1)
            else:
                order[node] = (s, -1)   # revisit: rewrite with newest step
            for j, (c, cm) in enumerate(zip(t.cand_ids[si, node],
                                            t.cand_mask[si, node])):
                if cm and int(c) not in order:
                    order[int(c)] = (s, j)
        vis_set = set(visited)
        visited_nodes = [n for n in order if n in vis_set]
        frontier = [n for n in order if n not in vis_set]
        # visited in path order, frontier in observation order (matches the
        # rollout's argsort key)
        visited_nodes = sorted(visited_nodes, key=lambda n: visited.index(n))
        tokens = visited_nodes + frontier
        tokens = tokens[: G - 2]

        gmap_nodes = np.full((G,), -1, np.int64)
        gmap_src_step = np.full((G,), -1, np.int32)
        gmap_src_slot = np.full((G,), -1, np.int32)
        gmap_step_ids = np.zeros((G,), np.int32)
        gmap_visited = np.zeros((G,), bool)
        gmap_masks = np.zeros((G,), bool)
        gmap_masks[0] = True
        gmap_visited[1] = True
        for g, n in enumerate(tokens, start=2):
            gmap_nodes[g] = n
            ss, sl = order[n]
            # visited nodes use the fused pano of their *latest* visit
            gmap_src_step[g] = ss
            gmap_src_slot[g] = sl if n not in vis_set else -1
            gmap_masks[g] = True
            if n in vis_set:
                gmap_visited[g] = True
                gmap_step_ids[g] = visited.index(n) + 1

        tok = np.array([n if n >= 0 else 0 for n in gmap_nodes])
        pos7 = gmap_pos_features(
            t.positions[si, cur], t.positions[si, tok],
            t.dist[si, cur, tok], t.steps[si, cur, tok].astype(np.float32),
            cur_h, cur_e, self.afs)
        null7 = np.concatenate([get_angle_fts(np.zeros(1), np.zeros(1),
                                              self.afs)[0], np.zeros(3)])
        gmap_pos_fts = np.where((gmap_nodes >= 0)[:, None], pos7,
                                null7[None, :]).astype(np.float32)
        gmap_pos_fts[:2] = null7
        pair = t.dist[si][np.ix_(tok, tok)] * \
            ((gmap_nodes >= 0)[:, None] & (gmap_nodes >= 0)[None, :])
        pair[:2, :] = 0
        pair[:, :2] = 0

        # vp inputs at the final step
        C = t.max_candidates
        cand_ids = t.cand_ids[si, cur]
        cand_mask = t.cand_mask[si, cur]
        start7 = gmap_pos_features(
            t.positions[si, cur], t.positions[si, path[0]][None],
            t.dist[si, cur, path[0]][None],
            np.asarray([t.steps[si, cur, path[0]]], np.float32),
            cur_h, cur_e, self.afs)[0]
        cand7 = gmap_pos_features(
            t.positions[si, cur], t.positions[si, np.maximum(cand_ids, 0)],
            t.dist[si, cur, np.maximum(cand_ids, 0)],
            t.steps[si, cur, np.maximum(cand_ids, 0)].astype(np.float32),
            cur_h, cur_e, self.afs)
        vp_pos_fts = np.zeros((P + 2, 14), np.float32)
        vp_pos_fts[:, :7] = start7
        vp_pos_fts[2 : 2 + C, 7:] = cand7 * cand_mask[:, None]
        vp_masks = np.concatenate([np.ones(2, bool), pano_masks[end_step]])
        vp_nav_masks = np.concatenate(
            [[True, False], nav_types[end_step] == 1])
        slot_of = {int(c): 2 + j for j, c in enumerate(cand_ids)
                   if cand_mask[j]}
        gmap_local_slot = np.full((G,), -1, np.int32)
        for g in range(2, G):
            if gmap_nodes[g] in slot_of:
                gmap_local_slot[g] = slot_of[gmap_nodes[g]]
        vp_cand_visited = np.zeros((P + 2,), np.float32)
        for j, c in enumerate(cand_ids):
            if cand_mask[j] and int(c) in vis_set:
                vp_cand_visited[2 + j] = 1.0

        # SAP labels.  R2R (R2RTextPathData.get_act_labels, dataset.py:
        # 622-638): stop at the gt end, else the gt next hop.  REVERIE items
        # (with pos_vps) follow ReverieTextPathData.get_act_labels
        # (dataset.py:322-346): stop when the endpoint is a pos viewpoint,
        # else the unvisited gmap node / candidate minimizing
        # dist(end, cand) + min_pos dist(cand, pos) — an SPL expert.
        reverie = "pos_vps_idx" in item
        if reverie and cur not in pos_set:
            g_label = l_label = -100
            best = np.inf
            pos_arr = np.asarray(sorted(pos_set))
            for g in range(2, G):
                n = int(gmap_nodes[g])
                if n < 0 or gmap_visited[g]:
                    continue
                d = t.dist[si, cur, n] + t.dist[si, n, pos_arr].min()
                if d < best:
                    best, g_label = d, g
            best = np.inf
            for j, c in enumerate(cand_ids):
                if not cand_mask[j]:
                    continue
                d = t.dist[si, cur, int(c)] + t.dist[si, int(c), pos_arr].min()
                if d < best:
                    best, l_label = d, 2 + j
        elif reverie:
            g_label, l_label = 0, 0
        elif end_step == k - 1:
            # stop at a true endpoint; a trajectory truncated by the step
            # budget has no clean next hop -> ignore
            g_label, l_label = (0, 0) if cur in pos_set else (-100, -100)
        else:
            nxt = path[end_step + 1]
            g_label = int(np.argmax(gmap_nodes == nxt)) \
                if (gmap_nodes == nxt).any() else -100
            l_label = slot_of.get(int(nxt), -100)

        txt = np.asarray(item["instr_encoding"], np.int32)[: self.L]
        txt_ids = np.full((self.L,), 1, np.int32)
        txt_masks = np.zeros((self.L,), bool)
        txt_ids[: len(txt)] = txt
        txt_masks[: len(txt)] = True

        return {
            "txt_ids": txt_ids, "txt_masks": txt_masks,
            "traj_view_fts": view_fts, "traj_loc_fts": loc_fts,
            "traj_nav_types": nav_types, "traj_pano_masks": pano_masks,
            "traj_step_masks": traj_mask, "final_step": np.int32(end_step),
            "gmap_src_step": gmap_src_step, "gmap_src_slot": gmap_src_slot,
            "gmap_step_ids": gmap_step_ids, "gmap_pos_fts": gmap_pos_fts,
            "gmap_masks": gmap_masks, "gmap_visited_masks": gmap_visited,
            "gmap_pair_dists": pair.astype(np.float32),
            "vp_pos_fts": vp_pos_fts, "vp_masks": vp_masks,
            "vp_nav_masks": vp_nav_masks, "gmap_local_slot": gmap_local_slot,
            "vp_cand_visited": vp_cand_visited,
            "sap_global_label": np.int32(g_label),
            "sap_local_label": np.int32(l_label),
            "end_node": np.int32(cur),
        }

    # ----- batches per task -----

    def collate(self, items, end_steps=None, end_vp_types=None):
        rows = [self.build_item(
            it, None if end_steps is None else end_steps[i],
            None if end_vp_types is None else end_vp_types[i])
            for i, it in enumerate(items)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def _sample_end_types(self, n, pos_ratio, neg_in_gt_ratio=None):
        """The reference per-sample endpoint draw (tasks.py:203-211 MRC,
        :343-351 SAP): r < pos_ratio -> pos; then neg_in_gt_path up to
        ``neg_in_gt_ratio`` (SAP: 0.6); the rest neg_others."""
        out = []
        for r in self.rng.random(n):
            if r < pos_ratio:
                out.append("pos")
            elif neg_in_gt_ratio is None or r < neg_in_gt_ratio:
                out.append("neg_in_gt_path")
            else:
                out.append("neg_others")
        return out

    def mlm_batch(self, items):
        # MLM always trains on the full positive path (tasks.py:190
        # end_vp_pos_ratio=1)
        batch = self.collate(items, end_vp_types=["pos"] * len(items))
        ids, labels = mlm_mask(batch["txt_ids"], self.rng, self.mask_token,
                               self.vocab_size)
        ids[~batch["txt_masks"]] = 1
        labels[~batch["txt_masks"]] = -100
        batch["txt_ids"] = ids
        batch["mlm_labels"] = labels
        return batch

    def mrc_batch(self, items, mask_prob=0.15, soft_targets=None,
                  end_vp_pos_ratio=0.2):
        """Mask 15% of the final step's views; soft targets are CLIP class
        probabilities when available, uniform-random otherwise.  Endpoints:
        pos at ``end_vp_pos_ratio``, neg_in_gt_path otherwise
        (MrcDataset, tasks.py:203-211; train_r2r_magic.py:51)."""
        batch = self.collate(items, end_vp_types=self._sample_end_types(
            len(items), end_vp_pos_ratio))
        B = len(items)
        view_mask = np.zeros((B, self.P), np.float32)
        for b in range(B):
            s = batch["final_step"][b]
            valid = batch["traj_pano_masks"][b, s]
            sel = (self.rng.random(self.P) < mask_prob) & valid
            if not sel.any() and valid.any():
                sel[self.rng.choice(np.flatnonzero(valid))] = True
            view_mask[b] = sel
            batch["traj_view_fts"][b, s][sel] = 0.0
        if soft_targets is None:
            raw = self.rng.random((B, self.P, self.prob_size)).astype(np.float32)
            soft_targets = raw / raw.sum(-1, keepdims=True)
        batch["mrc_view_mask"] = view_mask
        batch["mrc_targets"] = soft_targets
        return batch

    def sap_batch(self, items, end_vp_pos_ratio=0.2):
        """SAP endpoints: pos 0.2 / neg_in_gt_path 0.4 / neg_others 0.4 —
        the reference draw r<0.2 pos, r<0.6 neg_in_gt, else neg_others
        (SapDataset, tasks.py:343-351; train_r2r_magic.py:54)."""
        return self.collate(items, end_vp_types=self._sample_end_types(
            len(items), end_vp_pos_ratio, neg_in_gt_ratio=0.6))

    def cfp_batch(self, items):
        # CFP pools full positive trajectories (CfpDataset, tasks.py:575)
        return self.collate(items, end_vp_types=["pos"] * len(items))

    def og_batch(self, items, num_objects: int | None = None,
                 obj_feat_dim: int | None = None,
                 obj_features=None, obj_labels=None):
        """Object-grounding batch (OGDataset role, reference pretrain_src/
        data/tasks.py:455; object assembly dataset.py:483-512, labels
        get_obj_label :307-319).  When an ``obj_db`` is attached, endpoint
        objects come from the store: features, angle+box loc features
        (h/H, w/W, hw/HW over the 640x480 obj image, dataset.py:489-491),
        and the label is the index of the item's gt ``objId`` among the
        endpoint's object ids (-100 ignore when absent, :318).  Explicit
        ``obj_features``/``obj_labels`` override; deterministic synthetic
        objects otherwise."""
        batch = self.collate(items, end_vp_types=["pos"] * len(items))
        B = len(items)
        M = num_objects or (self.obj_db.max_objects if self.obj_db else 8)
        obj_loc = np.zeros((B, M, self.afs + 3), np.float32)
        if obj_features is not None:
            obj_features = np.asarray(obj_features, np.float32)
            obj_masks = np.ones((B, obj_features.shape[1]), bool)
            obj_labels = np.asarray(obj_labels, np.int32)
            obj_loc = np.zeros((B, obj_features.shape[1], self.afs + 3),
                               np.float32)
        elif self.obj_db is not None:
            d = obj_feat_dim or self.obj_db.dim
            obj_features = np.zeros((B, M, d), np.float32)
            obj_masks = np.zeros((B, M), bool)
            obj_labels = np.full((B,), -100, np.int32)
            for b, it in enumerate(items):
                g = self.world.graphs[it["scan_idx"]]
                vp = g.node_ids[int(batch["end_node"][b])]
                fts, attrs = self.obj_db.get(g.scan, vp)
                n = min(len(fts), M)
                if n == 0:
                    continue
                obj_features[b, :n] = fts[:n, :d]
                obj_masks[b, :n] = True
                ang = get_angle_fts(attrs["directions"][:n, 0],
                                    attrs["directions"][:n, 1], self.afs)
                w, h = attrs["sizes"][:n, 0], attrs["sizes"][:n, 1]
                img_w, img_h = self.obj_image_wh
                box = np.stack([h / img_h, w / img_w,
                                (w * h) / (img_h * img_w)], 1)
                obj_loc[b, :n] = np.concatenate([ang, box], 1)
                if "obj_pseudo_label" in it:
                    # SOON: pseudo-label index into the endpoint's objects,
                    # ignore when it overflows the object budget
                    # (SoonTextPathData.get_obj_label, dataset.py:799-803)
                    lbl = int(it["obj_pseudo_label"]["idx"])
                    obj_labels[b] = lbl if lbl < M else -100
                else:
                    gt = str(it.get("objId",
                                    it["instr_id"].split("_")[1]
                                    if it["instr_id"].count("_") >= 2 else ""))
                    ids = attrs["obj_ids"][:n]
                    obj_labels[b] = ids.index(gt) if gt in ids else -100
        else:
            d = obj_feat_dim or self.t.feat_dim
            obj_features = self.rng.standard_normal(
                (B, M, d)).astype(np.float32)
            obj_labels = self.rng.integers(0, M, B).astype(np.int32)
            obj_masks = np.ones((B, M), bool)
        batch["obj_fts"] = obj_features
        batch["obj_loc_fts"] = obj_loc
        batch["obj_masks"] = obj_masks
        batch["og_labels"] = np.asarray(obj_labels, np.int32)
        return batch
