"""Every seed gets the same jobs and requests in another order, and one
seed always the same order."""
from collections import Counter

from bench.drivers.engine_chat import Clients
from bench.traffic.jobs import PoissonJobs


def _stream(seed, until=200.0):
    jobs = PoissonJobs(4.0, seed=seed, pool_seed=11, pool_size=512,
                       work_range=(8.0, 40.0), mem_range_gb=(2.0, 12.0))
    return [(k, r.job_id, round(w, 9)) for k, r, w in jobs.take_until(until)], jobs


def test_stream_is_a_function_of_the_seed():
    a, _ = _stream(5)
    b, _ = _stream(5)
    c, _ = _stream(6)
    assert a == b and a != c


def test_stream_seeds_share_one_pool():
    _, a = _stream(5, until=1e4)
    _, b = _stream(6, until=1e4)
    pool = len(a.pool)
    work = lambda j: Counter(round(r.work, 9) for r in j.jobs[:pool])
    assert len(a.jobs) > pool and work(a) == work(b)


def test_stream_cell_draws_the_pool_its_file_names(monkeypatch):
    from bench.drivers import service_stream
    from bench.tests.small import run_small

    made = []

    class Kept(PoissonJobs):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(service_stream, "PoissonJobs", Kept)
    run_small("mig-pod64.stream", seed=41, pool_size=96)
    assert [len(j.pool) for j in made] == [96]


def test_requests_share_one_pool():
    p = {"pool_seed": 3, "pool_size": 64, "prompt_range": [8, 24],
         "output_range": [2, 6]}
    a, b = Clients(p, 100, seed=1), Clients(p, 100, seed=2)
    assert a.sizes != b.sizes and sorted(a.sizes) == sorted(b.sizes)
    assert Clients(p, 100, seed=1).sizes == a.sizes
