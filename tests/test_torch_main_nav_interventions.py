"""The port's navigation CLI with the causal interventions and ensembles
(vln_magic_tpu_torch.cli.main_nav) held against vln_magic_tpu.cli.main_nav
at tests/test_torch_main_nav.py's tiny synthetic flags, JAX's weights
reaching both CLIs as a ``.pt``: ``--mode valid`` with every text, view
and map head, the dictionaries rebuilt from the weights on the train
split, or read from ``--s_*_dict_file``/``--backdoor_dict_file`` TSVs
(metrics to 1e-5, equal trajectories and submission files);
``--mode extract_cfp_features`` (equal ids, features to 1e-5).  Port only:
``--mode train --z_instr_update --update_iter 1`` refreshes the
dictionaries (record lines, ``cfp_features_<role>_<it>.tsv``, both roles
under ``--train_kdl``), and ``--mode valid --ensemble_n 3`` runs.
"""

import numpy as np
import pytest
import torch

from test_torch_main_nav import (CPU, TINY, _check_valid, _valid_pair,
                                 config_of, out_args, shape_only_jax_init,
                                 write_weights)
from vln_magic_tpu.agent import interventions as J
from vln_magic_tpu.cli import main_nav as jax_cli
from vln_magic_tpu_torch.agent import interventions as P
from vln_magic_tpu_torch.cli import main_nav as cli

__all__ = ["shape_only_jax_init"]     # the autouse fixture, used here too

TOL = 1e-5
HEADS = ["--do_back_txt", "--do_front_txt", "--do_front_img",
         "--do_front_his"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny tensors, so that the test workers
    sharing the machine do not oversubscribe its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(tmp, flags, seed=3):
    cfg = config_of(TINY + flags + ["--mode", "valid"] + out_args(tmp, "cfg")
                    + CPU)
    return write_weights(tmp / "student.pt", cfg.model, seed), cfg


def _dict_files(tmp, dim):
    """A backdoor TSV in the kind-prefixed layout and a CFP feature TSV,
    written by JAX's writers from seeded numpy."""
    rng = np.random.default_rng(4)
    back = {kind: J.Zdict(rng.standard_normal((n, dim)).astype(np.float32),
                          rng.random(n) + 0.1, [f"{kind[0]}{i}"
                                                for i in range(n)])
            for kind, n in (("direction", 3), ("landmark", 5))}
    J.save_backdoor_tsv(str(tmp / "z.tsv"), back)
    feats = {k: rng.standard_normal((12, dim)).astype(np.float32)
             for k in ("txt", "gmap", "vp")}
    J.save_cfp_tsv(str(tmp / "cfp.tsv"), feats,
                   [f"{i}_0" for i in range(12)])
    return str(tmp / "z.tsv"), str(tmp / "cfp.tsv")


VALID = {
    # the dictionaries rebuilt from the loaded weights on the train split
    "rebuilt": lambda tmp, dim: HEADS,
    # the student's own files
    "student_files": lambda tmp, dim: HEADS + [
        "--s_backdoor_dict_file", _dict_files(tmp, dim)[0],
        "--s_frontdoor_dict_file", str(tmp / "cfp.tsv")],
    # the shared backdoor flag alone, with the backdoor head alone
    "shared_backdoor": lambda tmp, dim: [
        "--do_back_txt", "--backdoor_dict_file", _dict_files(tmp, dim)[0]],
}


@pytest.mark.parametrize("name", sorted(VALID))
def test_intervention_valid_matches_jax(tmp_path, name):
    heads = [f for f in VALID[name](tmp_path, 32) if f.startswith("--do")]
    pt, _ = _weights(tmp_path, heads)
    argv = TINY + ["--mode", "valid", "--submit", "--resume_file", pt] + \
        VALID[name](tmp_path, 32)
    pair = _valid_pair(tmp_path, argv)
    _check_valid(tmp_path, pair, ["val_seen", "val_unseen"])


def test_extract_cfp_features_matches_jax(tmp_path):
    pt, cfg = _weights(tmp_path, [])
    argv = TINY + ["--mode", "extract_cfp_features", "--resume_file", pt]
    got_path = cli.main(argv + out_args(tmp_path, "port") + CPU)
    want_path = jax_cli.main(argv + out_args(tmp_path, "jax"))
    assert got_path.endswith("cfp_features_5.tsv")
    d = cfg.model.hidden_size
    (got, gids), (want, wids) = (P.load_cfp_tsv(got_path, d),
                                 J.load_cfp_tsv(want_path, d))
    assert gids == wids and len(gids) == 8
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("kdl", [False, True], ids=["student", "both_roles"])
def test_train_refreshes_the_dictionaries(tmp_path, kdl, monkeypatch):
    """Iteration 0, every ``--update_iter`` and each new best rebuild both
    dictionaries of each role, write the CFP TSVs, and the train steps run
    with them."""
    from vln_magic_tpu_torch.agent import trainer as port_trainer

    seen = []
    real = port_trainer.Trainer.train_step

    def train_step(self, items, zdicts=None):
        seen.append(sorted(self.zdicts))
        return real(self, items, zdicts)

    monkeypatch.setattr(port_trainer.Trainer, "train_step", train_step)
    argv = TINY + HEADS + ["--mode", "train", "--z_instr_update",
                           "--update_iter", "1", "--iters", "2",
                           "--log_every", "1"] + \
        (["--train_kdl"] if kdl else []) + out_args(tmp_path, "t") + CPU
    trainer = cli.main(argv)
    roles = ["student", "teacher"] if kdl else ["student"]
    assert seen == [roles, roles]
    assert sorted(trainer.zdicts) == roles
    for role in roles:
        z = trainer.zdicts[role]
        assert z["instr_zdict"]["direction_features"].shape[0] == 81
        assert z["front_txt_feats"].shape[0] == 8    # min(24, 8 items)
    args = cli.parse_args(argv)
    record = open(f"{args.log_dir}/train.txt").read()
    for it in (0, 1, 2):
        assert f"iter {it}: refreshed intervention dicts for {roles}" \
            in record
        for role in roles:
            feats, ids = P.load_cfp_tsv(
                f"{args.ckpt_dir}/cfp_features_{role}_{it}.tsv", 64)
            assert len(ids) == 8 and np.isfinite(feats["txt"]).all()


def test_valid_with_an_ensemble_runs(tmp_path):
    pt, _ = _weights(tmp_path, [])
    results = cli.main(TINY + ["--mode", "valid", "--ensemble_n", "3",
                               "--resume_file", pt] +
                       out_args(tmp_path, "e") + CPU)
    assert sorted(results) == ["val_seen", "val_unseen"]
    for avg in results.values():
        assert all(np.isfinite(v) for v in avg.values())
