"""The port's command lines against the JAX package's scripts, and the
trajectory that ``--trajectory_bf16`` stores, on the CPU.

* Parity: for each of the 12 scripts with a port CLI, the parser that the
  script's ``main()`` builds (taken where it parses, in this process; the
  scripts expose no parser of their own) and the port CLI's: every JAX
  flag but ``--scan_layers`` (the port reads scan-layout weights instead)
  is one of the port's, and one command line holding every JAX flag with
  a value parses in both to the same values.
* ``--trajectory_bf16`` (hidden 32, 1 layer, DDPM over 5 steps, f32
  compute, every test batch): the pickle holds f32 arrays equal to the
  f32 run's trajectory rounded to bf16, in the layout and type of the JAX
  package's ``trajectory_dtype=bfloat16``; and ``sample_structure_batches``
  (which copies batch n to the host while batch n+1 samples) gives the
  arrays of a loop that copies each batch before the next.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("create_pdb", "preprocess", "convert_data", "prune_ckpt", "serve",
        "train_structure", "train_sequence", "evaluate",
        "sample_by_generated_angles", "sample_structure", "sample_sequence",
        "run_pipeline")
JAX_ONLY = {"--scan_layers"}
TINY = ["--hidden_size", "32", "--num_heads", "4", "--num_hidden_layers",
        "1", "--intermediate_size", "64", "--timesteps", "5", "--bf16",
        "false", "--batch_size", "3"]


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__()
        self.parser = parser


def _parser_of(main, monkeypatch, *args) -> argparse.ArgumentParser:
    """The parser ``main`` builds, taken when it parses."""
    def grab(self, *a, **k):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        try:
            main(*args)
        except _Parsed as e:
            return e.parser
    raise AssertionError(f"{main} parsed no command line")


def _jax_main(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def _value(action) -> str:
    """A value the action takes."""
    if action.choices:
        return str(next(iter(action.choices)))
    if action.type is int:
        return "2"
    if action.type is float:
        return "0.5"
    if getattr(action.type, "__name__", "") == "parse_bool_flag":
        return "true"
    return "x"


def _flags(parser) -> dict[str, argparse.Action]:
    return {o: a for a in parser._actions for o in a.option_strings
            if o.startswith("--") and o != "--help"}


@pytest.mark.parametrize("name", CLIS)
def test_every_jax_flag_parses_in_the_port_cli(name, monkeypatch):
    jparser = _parser_of(_jax_main(name), monkeypatch)
    port = importlib.import_module(f"e3diff_tpu_torch.cli.{name}")
    pparser = _parser_of(port.main, monkeypatch, [])
    jflags, pflags = _flags(jparser), _flags(pparser)
    missing = sorted(set(jflags) - JAX_ONLY - set(pflags))
    assert not missing, f"{name}: the port lacks {missing}"
    argv = [_value(a) for a in jparser._actions if not a.option_strings]
    for flag, action in jflags.items():
        if flag not in JAX_ONLY and flag == action.option_strings[0]:
            argv += [flag] + ([] if action.nargs == 0 else [_value(action)])
    jargs, pargs = jparser.parse_args(argv), pparser.parse_args(argv)
    for flag, action in jflags.items():
        if flag not in JAX_ONLY:
            assert getattr(pargs, pflags[flag].dest) == getattr(
                jargs, action.dest), (name, flag)


# ------------------------------------------------------- the trajectory

def _port_pickle(tmp_path, name, *extra):
    from e3diff_tpu_torch.cli.sample_structure import main

    out = tmp_path / f"{name}.pkl"
    main(["--synthetic", "--device", "cpu", "--all_batches", *TINY,
          "--output", str(out), *extra])
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trajectory")
    return {name: _port_pickle(tmp, name, *extra) for name, extra in
            (("f32", ()), ("bf16", ("--trajectory_bf16",)))}


def test_trajectory_bf16_pickle_is_the_f32_trajectory_rounded(pickles):
    f32, bf16 = pickles["f32"], pickles["bf16"]
    assert len(f32) == len(bf16) > 3   # more than one batch
    for a, b in zip(f32, bf16, strict=True):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        want = torch.from_numpy(a).bfloat16().float().numpy()
        np.testing.assert_array_equal(b, want)
    assert any(not np.array_equal(a, b) for a, b in zip(f32, bf16))


def test_trajectory_bf16_layout_and_type_match_jax(pickles):
    """The JAX package's ``trajectory_dtype=bfloat16`` over the same test
    batches (its own random weights): the same list of (5, len_i, 8) f32
    arrays of bf16 values."""
    from e3diff_tpu.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu.sampling import sample_structure_batches
    from e3diff_tpu.utils.builders import (
        build_structure_diffusion,
        build_structure_model,
    )
    from e3diff_tpu.utils.presets import structure_sample_config

    cfg = structure_sample_config(hidden_size=32, num_heads=4,
                                  num_hidden_layers=1, intermediate_size=64,
                                  timesteps=5, bf16=False, batch_size=3)
    ds = LigandBindingSiteData(synthetic_complexes(n=32), "test",
                               cfg.max_seq_len, cfg.pocket_ext,
                               cfg.ligand_max_len)
    model = build_structure_model(cfg)
    b = {k: jnp.asarray(v) for k, v in next(ds.batches(3)).items()
         if k in ("ligand_angles", "ligand_attn_mask", "receptor_seq",
                  "receptor_angles", "receptor_attn_mask")}
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((3,), jnp.int32),
                        b["ligand_angles"], b["ligand_attn_mask"],
                        b["receptor_seq"], b["receptor_angles"],
                        b["receptor_attn_mask"])["params"]
    got = sample_structure_batches(
        params, model, build_structure_diffusion(cfg), ds.batches(3),
        jax.random.PRNGKey(1), first_batch_only=False,
        trajectory_dtype=jnp.bfloat16)
    port = pickles["bf16"]
    assert [a.shape for a in got] == [a.shape for a in port]
    for a in (*got, *port):
        assert a.dtype == np.float32
        assert a.shape[0] == cfg.timesteps and a.shape[-1] == 8
        np.testing.assert_array_equal(
            a, torch.from_numpy(a).bfloat16().float().numpy())


@pytest.mark.parametrize("trajectory", [True, False])
def test_overlapped_host_copies_give_the_serial_loop_arrays(trajectory):
    """``sample_structure_batches`` against the loop it replaced, which
    copied each batch to the host before sampling the next: the same
    arrays, every batch."""
    from e3diff_tpu_torch.data import LigandBindingSiteData, synthetic_complexes
    from e3diff_tpu_torch.sampling import (
        make_structure_sampler,
        sample_structure_batches,
    )
    from e3diff_tpu_torch.utils.builders import (
        build_structure_diffusion,
        build_structure_model,
    )
    from e3diff_tpu_torch.utils.presets import structure_sample_config

    cfg = structure_sample_config(hidden_size=32, num_heads=4,
                                  num_hidden_layers=1, intermediate_size=64,
                                  timesteps=5, bf16=False)
    ds = LigandBindingSiteData(synthetic_complexes(n=32), "test",
                               cfg.max_seq_len, cfg.pocket_ext,
                               cfg.ligand_max_len)
    model = build_structure_model(cfg, device="cpu", seed=0)
    diffusion = build_structure_diffusion(cfg, device="cpu")
    got = sample_structure_batches(
        model, diffusion, ds.batches(3), device="cpu", seed=3,
        first_batch_only=False, return_trajectory=trajectory,
        trajectory_dtype=torch.bfloat16)
    run = make_structure_sampler(model, diffusion,
                                 return_trajectory=trajectory,
                                 trajectory_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    want = []
    for batch in ds.batches(3):
        final, traj = run({k: torch.as_tensor(batch[k]) for k in (
            "ligand_angles", "ligand_attn_mask", "receptor_seq",
            "receptor_angles", "receptor_attn_mask")}, gen)
        out = (traj if trajectory else final).float().cpu().numpy()
        lengths = batch["ligand_attn_mask"].sum(1).astype(int)
        want += [out[..., i, :lengths[i], :] for i in
                 range(int(batch["num_valid"]))]
    assert len(got) == len(want) > 3   # more than one batch
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
