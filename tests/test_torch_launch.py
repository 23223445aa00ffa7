"""tpu_ac_torch.distributed.launch: tpu_ac's tests/test_video_seg.py
TestLauncher cases, run against both packages' launchers (no device, no
tolerance)."""

import dataclasses

import pytest

from tpu_ac.distributed import launch as jlaunch
from tpu_ac_torch.distributed import launch as tlaunch

PACKAGES = pytest.mark.parametrize("launch", [jlaunch, tlaunch],
                                   ids=["tpu_ac", "tpu_ac_torch"])


@PACKAGES
def test_requeue_until_success(launch):
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("preempted")
        return "done"

    out = launch.run_with_requeue(flaky, launch.LaunchConfig(
        max_restarts=5, restart_delay_s=0.0))
    assert out == "done" and calls["n"] == 3


@PACKAGES
def test_gives_up_after_max_restarts(launch):
    def always_fails():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="after 2 restarts"):
        launch.run_with_requeue(always_fails, launch.LaunchConfig(
            max_restarts=2, restart_delay_s=0.0))


@PACKAGES
def test_fatal_exceptions_pass_through(launch):
    calls = []

    def interrupted():
        calls.append(1)
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        launch.run_with_requeue(interrupted, launch.LaunchConfig(
            restart_delay_s=0.0))
    assert calls == [1]


@PACKAGES
def test_on_restart_sees_each_failure(launch):
    seen = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ValueError(f"try {calls['n']}")
        return calls["n"]

    assert launch.run_with_requeue(
        flaky, launch.LaunchConfig(max_restarts=3, restart_delay_s=0.0),
        on_restart=lambda k, e: seen.append((k, str(e)))) == 3
    assert seen == [(1, "try 1"), (2, "try 2")]


def test_defaults_equal_tpu_ac():
    assert dataclasses.asdict(tlaunch.LaunchConfig()) == \
        dataclasses.asdict(jlaunch.LaunchConfig())
