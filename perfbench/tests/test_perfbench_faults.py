"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run on the CPU (the harness's look for a
card skipped) with one fault planted in the port's path: an executor that
returns its state unchanged (stores never written), half of the batch left
out, an answer altered where it is produced; a mapper that places a node
where its operands cannot reach it, or leaves half the suite out."""

from __future__ import annotations

import pytest
import torch

import repro_torch.core.service as service
import repro_torch.kernels.ops as ops

from ._small import run_small, small_context

EXEC = "table3-mesh4.exec"
COMPILE = "table3-mesh20.compile"


def _broken_executor(monkeypatch, fault):
    real = ops.cgra_run

    def cgra_run(program, inputs, num_iters, **kw):
        outs, trace = real(program, inputs, num_iters, **kw)
        return {v: fault(o.clone()) for v, o in outs.items()}, trace

    monkeypatch.setattr(ops, "cgra_run", cgra_run)


def _unchanged(o):
    return torch.zeros_like(o)


def _half(o):
    o[:, o.shape[1] // 2:] = 0
    return o


def _altered(o):
    o[-1, -1] += 1
    return o


@pytest.mark.parametrize("cell", [EXEC, COMPILE])
def test_a_sound_run_is_correct(cell):
    assert run_small(small_context(cell)).correct


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", [EXEC, COMPILE])
def test_a_broken_executor_is_not_correct(monkeypatch, cell, fault):
    _broken_executor(monkeypatch, fault)
    result = run_small(small_context(cell))
    assert not result.correct
    assert result.checks["store_mismatches"]["value"] > 0 and result.failed > 0


def _broken_mapper(monkeypatch, fault):
    real = service.compile_many

    def compile_many(batch, **kw):
        report = real(batch, **kw)
        fault(report)
        return report

    monkeypatch.setattr(service, "compile_many", compile_many)


def _moved(report):
    job = next(j for j in report.jobs if j.ok and len(j.placement) > 2)
    job.placement = list(job.placement)
    job.placement[0] = 399 if job.placement[0] < 200 else 0


def _half_left_out(report):
    report.jobs = report.jobs[: len(report.jobs) // 2]


@pytest.mark.parametrize("fault,number", [(_moved, "illegal_mappings"),
                                          (_half_left_out, "unmapped")])
def test_a_broken_mapper_is_not_correct(monkeypatch, fault, number):
    _broken_mapper(monkeypatch, fault)
    result = run_small(small_context(COMPILE))
    assert not result.correct and result.checks[number]["value"] > 0
