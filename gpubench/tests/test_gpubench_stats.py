"""The end-to-end readers: mpix_s is all the window's work over all its
time, job_ms_p95 the tail of every job."""

import pytest

from gpubench import stats
from gpubench.run import Context, Job
from gpubench.spec import Bench
from conftest import REPO


def ctx(jobs, window_s, pixels=1_000_000, **kw):
    base = dict(setup_s=12.5, jobs=jobs, window_s=window_s, pixels=pixels,
                peak_bytes=3 * 2 ** 30, trace=None, work=(0, 0), cards=1,
                port_kernels=frozenset())
    base.update(kw)
    return Context(**base)


def read(name, c):
    return Bench(REPO).reader(name).read(c)


def test_mpix_s_is_every_completed_job_over_the_whole_window():
    # 9 completed jobs and a failed one in a 2.5 s window: the window's
    # own length, not the jobs' summed latencies (1.8 s)
    jobs = [Job(i * 0.25, i * 0.25 + 0.05, i * 0.25 + 0.2, True, False)
            for i in range(9)] + [Job(2.3, 2.3, 2.5, False, False)]
    assert read("mpix_s", ctx(jobs, 2.5)) == pytest.approx(9 * 1.0 / 2.5)


def test_job_ms_p95_is_the_nearest_rank_tail_of_all_jobs():
    lat = [0.001 * (i + 1) for i in range(200)]     # 1 .. 200 ms
    jobs = [Job(10.0, 10.0, 10.0 + x, True, False) for x in lat[::-1]]
    assert read("job_ms_p95", ctx(jobs, 1.0)) == pytest.approx(190.0)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([1, 2, 3, 4], 50) == 2


def test_setup_and_peak_are_read_as_given():
    c = ctx([Job(0, 0, 1, True, False)], 1.0)
    assert read("setup_s", c) == 12.5
    assert read("peak_gib", c) == 3.0


def test_api_host_ms_leaves_out_the_traced_jobs():
    jobs = [Job(0.0, 0.002, 0.004, True, False),
            Job(1.0, 1.004, 1.006, True, False),
            Job(2.0, 2.050, 2.060, True, True)]      # under the profiler
    assert read("api.host_ms", ctx(jobs, 3.0)) == pytest.approx(3.0)


def test_a_window_with_no_completed_job_reads_nothing():
    jobs = [Job(0.0, 0.1, 0.2, False, False)]
    assert read("mpix_s", ctx(jobs, 0.2)) is None
    assert read("job_ms_p95", ctx(jobs, 0.2)) is None
