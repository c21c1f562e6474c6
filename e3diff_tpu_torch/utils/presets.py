"""Experiment configurations, their flags and their checkpoint sidecars
(the port's copy of e3diff_tpu/utils/presets.py; the models, diffusions
and datasets they describe are built by utils/builders.py).

The reference has no flag system: every entry script carries an inline
CONFIG (structure_model/train_model.py:18-39, sample.py:20-41;
sequence_model/train_model.py:17-39). These presets are the typed
equivalents; the CLIs expose every field as a flag.

A ``config.json`` sidecar written next to a checkpoint by either package
reads here: the fields the port has are taken from it, the JAX package's
XLA layout field scan_layers is left out (the port reads scan-layout
weights, utils/weights.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile


@dataclasses.dataclass
class ExperimentConfig:
    # data
    pocket_ext: int = 4
    max_seq_len: int = 128
    ligand_max_len: int | None = None   # None = max_seq_len
    # diffusion
    timesteps: int = 1000
    # model
    num_heads: int = 12
    hidden_size: int = 768
    num_hidden_layers: int = 12
    intermediate_size: int = 1024
    position_embedding_type: str = "relative_key"
    noise_schedule: str = "cosine"   # the only schedule either package has
    dropout_p: float = 0.1
    # optimization
    lr: float = 5e-5
    l2_norm: float = 0.1             # AdamW weight decay
    gradient_clip: float = 1.0
    lr_scheduler: str = "LinearWarmup"   # per-epoch warmup (Q12)
    # accepted for the reference's CONFIG; inert without early stopping,
    # as in the reference (every run trains max_epochs)
    min_epochs: int = 150
    max_epochs: int = 350
    batch_size: int = 64
    # runtime
    bf16: bool = True   # compute dtype: bf16, or f32
    seed: int = 0
    ckpt_every: int = 1              # 'last' (resume) save cadence, epochs
    # best_val_model selection: "max" is Q4-faithful (the reference keeps
    # the WORST val_loss epoch); "min" keeps the best
    ckpt_mode: str = "max"
    ema_decay: float = 0.0           # 0 = off; else a final_ema artifact
    accum_steps: int = 1             # microbatches per step (interleaved)
    mu_dtype: str = "f32"            # AdamW first moment: f32 or bf16
    cond_dropout: float = 0.0        # classifier-free guidance training
    # activation checkpointing of the stack layers in training: none |
    # layer | dots (models/blocks.py::TransformerStack; the numbers are
    # unchanged, peak memory against a second forward in the backward)
    remat: str = "none"


def structure_train_config(**overrides) -> ExperimentConfig:
    """structure_model/train_model.py:18-39."""
    cfg = ExperimentConfig(pocket_ext=4, max_seq_len=128, timesteps=1000,
                           num_hidden_layers=12, min_epochs=150,
                           max_epochs=350)
    return dataclasses.replace(cfg, **overrides)


def sequence_train_config(**overrides) -> ExperimentConfig:
    """sequence_model/train_model.py:17-39."""
    cfg = ExperimentConfig(pocket_ext=4, max_seq_len=128, timesteps=50,
                           num_hidden_layers=6, min_epochs=100,
                           max_epochs=150)
    return dataclasses.replace(cfg, **overrides)


def structure_sample_config(**overrides) -> ExperimentConfig:
    """structure_model/sample.py:20-41 (ext 0, max_len 64)."""
    cfg = ExperimentConfig(pocket_ext=0, max_seq_len=64, timesteps=1000,
                           num_hidden_layers=12)
    return dataclasses.replace(cfg, **overrides)


def sequence_sample_config(**overrides) -> ExperimentConfig:
    """sequence_model/sample.py:28-50 (ext 0, max_len 64, 50 steps)."""
    cfg = ExperimentConfig(pocket_ext=0, max_seq_len=64, timesteps=50,
                           num_hidden_layers=6)
    return dataclasses.replace(cfg, **overrides)


def parse_bool_flag(s: str) -> bool:
    """Strict bool parser: an unknown spelling is an error, not False."""
    low = s.strip().lower()
    if low in ("true", "1", "yes", "on"):
        return True
    if low in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"expected true/false, got {s!r}")


def add_config_flags(parser, defaults: ExperimentConfig):
    """One ``--field`` flag per ExperimentConfig field, defaulting to
    ``defaults``."""
    for f in dataclasses.fields(ExperimentConfig):
        val = getattr(defaults, f.name)
        if isinstance(val, bool):
            parser.add_argument(f"--{f.name}", type=parse_bool_flag,
                                default=val)
        else:
            typ = type(val) if val is not None else int
            parser.add_argument(f"--{f.name}", type=typ, default=val)
    return parser


def config_from_args(args) -> ExperimentConfig:
    return ExperimentConfig(**{f.name: getattr(args, f.name)
                               for f in dataclasses.fields(ExperimentConfig)})


# Fields that must agree with the checkpoint being resumed: they size the
# parameter tree or define the diffusion process and the data shapes the
# weights were trained against; ema_decay and mu_dtype shape the resumable
# train state.
CKPT_BOUND_FIELDS = (
    "pocket_ext", "max_seq_len", "ligand_max_len", "timesteps",
    "noise_schedule", "num_heads", "hidden_size", "num_hidden_layers",
    "intermediate_size", "position_embedding_type",
)
TRAIN_BOUND_FIELDS = CKPT_BOUND_FIELDS + ("ema_decay", "mu_dtype")


def save_config(cfg: ExperimentConfig, ckpt_dir: str) -> str:
    """Write ``config.json`` next to the checkpoints (atomically: a temp
    file, then os.replace), so that samplers and ``DesignEngine`` recover
    the trained architecture."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "config.json")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, prefix=".config.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _flag_on_command_line(name: str, argv, known_flags=None) -> bool:
    """True when --name appeared in ``argv`` (as '--name v', '--name=v' or
    an abbreviation that argparse resolves to it)."""
    for a in argv:
        if not a.startswith("--"):
            continue
        tok = a[2:].split("=", 1)[0]
        if tok == name:
            return True
        if known_flags and tok and name.startswith(tok) \
                and tok not in known_flags:
            if {f for f in known_flags if f.startswith(tok)} == {name}:
                return True
    return False


def _parser_flag_names(parser) -> list[str]:
    """Every ``--name`` the parser knows, without the dashes."""
    return [o[2:] for a in parser._actions for o in a.option_strings
            if o.startswith("--")]


def adopt_ckpt_config(cfg: ExperimentConfig, parser, ckpt_path,
                      fields=CKPT_BOUND_FIELDS, argv=None
                      ) -> tuple[ExperimentConfig, dict]:
    """Take each of ``fields`` from the ``config.json`` sidecar beside
    ``ckpt_path`` unless its flag is on the command line (``argv``, or
    sys.argv; an explicit flag wins even when it repeats the default), as
    the JAX package's sampling scripts do, so that a checkpoint samples
    with the widths, data shapes and diffusion it was trained with.
    Returns (cfg, adopted {field: value}) and prints what it adopted.
    Without a checkpoint or a sidecar, cfg is returned as it is."""
    side = None if ckpt_path is None else load_ckpt_config(ckpt_path)
    if side is None:
        return cfg, {}
    argv = sys.argv[1:] if argv is None else argv
    known = _parser_flag_names(parser)
    adopted = {name: side[name] for name in fields
               if name in side and getattr(cfg, name) != side[name]
               and not _flag_on_command_line(name, argv, known)}
    if adopted:
        cfg = dataclasses.replace(cfg, **adopted)
        print(f"adopted from {ckpt_path} config.json: "
              + ", ".join(f"{k}={v}" for k, v in adopted.items()))
    return cfg, adopted


def reconcile_run_config(cfg: ExperimentConfig, ckpt_dir: str, parser=None,
                         argv=None) -> tuple[ExperimentConfig, dict]:
    """Make a training invocation agree with an existing run directory.
    When ``ckpt_dir`` holds checkpoints and a sidecar, every
    TRAIN_BOUND_FIELD that differs is adopted from the sidecar when its
    flag was not given (a resume "just works"), and is an error when it was
    (the directory holds another run). Returns (cfg, adopted)."""
    side = load_ckpt_config(ckpt_dir)
    has_ckpt = any(os.path.isfile(os.path.join(ckpt_dir, f"{n}.pt"))
                   for n in ("last", "final", "best_val_model"))
    if side is None or not has_ckpt:
        return cfg, {}
    argv = sys.argv[1:] if argv is None else argv
    known = None if parser is None else _parser_flag_names(parser)
    adopted, conflicts = {}, []
    for name in TRAIN_BOUND_FIELDS:
        if name not in side or getattr(cfg, name) == side[name]:
            continue
        if _flag_on_command_line(name, argv, known):
            conflicts.append(
                f"--{name}={getattr(cfg, name)} vs checkpoint {side[name]}")
        else:
            adopted[name] = side[name]
    if conflicts:
        raise SystemExit(
            f"{ckpt_dir} holds a run trained with a different "
            f"configuration: {'; '.join(conflicts)}. Use a fresh "
            "--ckpt_dir for a new configuration (or drop the flag to keep "
            "the checkpoint's value).")
    if adopted:
        cfg = dataclasses.replace(cfg, **adopted)
        print("resume: adopted from config.json: "
              + ", ".join(f"{k}={v}" for k, v in adopted.items()))
    return cfg, adopted


# fields the structure and the sequence checkpoint of one engine must
# share: the data shapes and the widths (their timesteps and depths differ)
SHARED_FIELDS = (
    "pocket_ext", "max_seq_len", "ligand_max_len", "num_heads",
    "hidden_size", "intermediate_size", "position_embedding_type",
)


def check_shared_fields(cfg: ExperimentConfig, sequence_side: dict | None
                        ) -> None:
    """Raise ValueError when the sequence checkpoint's sidecar disagrees
    with the structure configuration on a SHARED_FIELDS value."""
    for k in SHARED_FIELDS:
        if k in (sequence_side or {}) and sequence_side[k] != getattr(cfg, k):
            raise ValueError(
                f"checkpoint configs disagree on {k}: structure="
                f"{getattr(cfg, k)} vs sequence={sequence_side[k]}")


def load_ckpt_config(ckpt_path: str) -> dict | None:
    """The ``config.json`` sidecar in the checkpoint's directory (or in
    ``ckpt_path`` itself when it is a directory), or None."""
    ckpt_path = os.path.abspath(ckpt_path)
    for d in (ckpt_path, os.path.dirname(ckpt_path)):
        path = os.path.join(d, "config.json")
        if os.path.isfile(path):
            with open(path) as f:
                return json.load(f)
    return None


def config_from_sidecar(base: ExperimentConfig, side: dict | None
                        ) -> ExperimentConfig:
    """``base`` with every field the sidecar names replaced by its value."""
    names = {f.name for f in dataclasses.fields(ExperimentConfig)}
    return dataclasses.replace(base, **{k: v for k, v in (side or {}).items()
                                        if k in names})
