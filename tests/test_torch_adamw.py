"""The host side of the fused clipping and AdamW update
(ops/kernels.py::adamw_update, csrc/adamw.cu): its chunk list, launches
and tensor table, and the CPU path, which is the plain chain.

The kernel itself runs only on the card: chip_smoke.py's phase 12 (i)
holds it to ``adamw_update_plain`` bit for bit there."""

from __future__ import annotations

import math

import pytest
import torch

from e3diff_tpu_torch.ops import kernels
from e3diff_tpu_torch.training import AdamW

SIZES = [(1,), (3,), (768,), (768, 1024), (2 * kernels.ADAMW_CHUNK + 5,)]
MU_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _lists(mu_dtype):
    params = [torch.zeros(s) for s in SIZES]
    grads = [torch.zeros(s) for s in SIZES]
    mu = [torch.zeros(s, dtype=MU_DTYPES[mu_dtype]) for s in SIZES]
    nu = [torch.zeros(s) for s in SIZES]
    return params, grads, mu, nu


@pytest.mark.parametrize("mu_dtype", list(MU_DTYPES))
@pytest.mark.parametrize("max_tensors", [1, 2, 1000])
def test_chunks_and_table_cover_every_element_once(mu_dtype, max_tensors):
    lists = _lists(mu_dtype)
    numels = [math.prod(s) for s in SIZES]
    chunks = kernels.adamw_chunks(numels)
    by_ptr = {t.data_ptr(): t for ts in lists for t in ts}
    cover = {id(t): torch.zeros(t.numel(), dtype=torch.int32)
             for ts in lists for t in ts}
    groups = kernels.adamw_groups(numels, max_tensors)
    assert [g[0] for g in groups] == list(range(0, len(SIZES), max_tensors))
    assert groups[-1][1] == len(SIZES) and groups[-1][3] == len(chunks)
    for t0, t1, c0, c1 in groups:
        assert t1 - t0 <= max_tensors
        table = kernels.adamw_tensor_table(*lists, t0, t1)
        assert len(table) == 4 * (t1 - t0)
        for tensor, start, length, _ in chunks[c0:c1].tolist():
            assert t0 <= tensor < t1
            # the kernel's 4-wide vectors whole from the chunk's start; it
            # ends at its tensor's end or earlier
            assert start % 4 == 0
            assert 0 < length <= kernels.ADAMW_CHUNK
            assert start + length <= numels[tensor]
            slots = table[4 * (tensor - t0):4 * (tensor - t0) + 4]
            for slot, (ts, ptr) in enumerate(zip(lists, slots)):
                t = by_ptr[ptr]
                assert t is ts[tensor]
                assert t.dtype == (MU_DTYPES[mu_dtype] if slot == 2
                                   else torch.float32)
                cover[id(t)][start:start + length] += 1
    assert all(bool((c == 1).all()) for c in cover.values())


def _opt(mu_dtype, params):
    return AdamW({f"w{i}": p for i, p in enumerate(params)}, base_lr=1e-2,
                 weight_decay=0.1, max_epochs=4, steps_per_epoch=2,
                 grad_clip=1.0, mu_dtype=mu_dtype)


def _grads(step: int):
    gen = torch.Generator().manual_seed(step)
    # the clip taken at even steps, left at odd ones
    scale = 10.0 if step % 2 == 0 else 1e-3
    return [torch.randn((5, 7), generator=gen) * scale,
            torch.randn((3,), generator=gen) * scale]


def _state(opt):
    return [*opt.params, *opt.mu, *opt.nu, opt.count]


@pytest.mark.parametrize("mu_dtype", list(MU_DTYPES))
def test_cpu_step_is_the_plain_version_and_resumes(mu_dtype, monkeypatch):
    calls = []
    plain = kernels.adamw_update_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(kernels, "adamw_update_plain", spy)
    launches = kernels.adamw_update.launches
    init = [torch.randn((5, 7), generator=torch.Generator().manual_seed(9)),
            torch.randn((3,), generator=torch.Generator().manual_seed(10))]
    straight = _opt(mu_dtype, [p.clone() for p in init])
    for k in range(4):
        straight.step(_grads(k))
    assert len(calls) == 4
    assert kernels.adamw_update.launches == launches

    first = _opt(mu_dtype, [p.clone() for p in init])
    for k in range(2):
        first.step(_grads(k))
    saved = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in first.state_dict().items()}
    resumed = _opt(mu_dtype, [p.detach().clone() for p in first.params])
    resumed.load_state_dict(saved)
    for k in range(2, 4):
        resumed.step(_grads(k))
    for a, b in zip(_state(straight), _state(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_adamw_update_refuses_what_it_does_not_take():
    params, grads, mu, nu = _lists("f32")
    norm, count = torch.ones(()), torch.zeros((), dtype=torch.int64)
    table = torch.zeros((4, 3))
    kw = dict(grad_clip=1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    with pytest.raises(ValueError, match="grads"):
        kernels.adamw_update(params, grads[:-1], mu, nu, norm, table, count,
                             **kw)
    with pytest.raises(ValueError, match="shapes"):
        kernels.adamw_update(params, [g.reshape(-1, 1) for g in grads], mu,
                             nu, norm, table, count, **kw)
    with pytest.raises(ValueError, match="norm"):
        kernels.adamw_update(params, grads, mu, nu, norm.reshape(1), table,
                             count, **kw)
    meta = [[t.to("meta") for t in ts] for ts in (params, grads, mu, nu)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        kernels.adamw_update(*meta, norm.to("meta"), table.to("meta"),
                             count.to("meta"), **kw)
