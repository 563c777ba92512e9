"""Seeded inputs: the SoA fans' lanes and the lanes checked repeat for a
seed and change with it; every seed offers the same work."""
import pytest

from h100bench import harness
from h100bench.systems import soa

BIG = 2 ** 31 + 12345


def test_soa_fan_lanes_repeat_and_do_not_overlap():
    seeds, rows = soa._fan_lanes(BIG, 2, 1024, 10 ** 6, 4)
    again = soa._fan_lanes(BIG, 2, 1024, 10 ** 6, 4)
    assert seeds == again[0] and rows.tolist() == again[1].tolist()
    assert seeds[0] == BIG * 10 ** 6 + 2 * 1024 and len(set(seeds)) == 1024
    assert len(rows) == 4 and len(set(rows.tolist())) == 4
    other = soa._fan_lanes(BIG, 3, 1024, 10 ** 6, 4)[0]
    assert not set(seeds) & set(other)


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 33 + 1])
def test_every_seed_offers_the_same_work(seed):
    """A fan is 1024 lanes of the one drive whatever the seed; the seed
    picks which lanes and which of them are checked."""
    seeds, rows = soa._fan_lanes(seed, 0, 1024, 10 ** 6, 32)
    assert len(seeds) == 1024 and len(set(seeds)) == 1024
    assert len(rows) == 32 and rows.min() >= 0 and rows.max() < 1024
    assert rows.tolist() != soa._fan_lanes(seed + 1, 0, 1024, 10 ** 6, 32)[1].tolist()


def test_traffic_files_name_what_their_system_reads():
    bench = harness.load_benchmark()
    for c in bench["workloads"]:
        mix = harness.load_traffic(c["traffic"])
        assert harness.load_config(c["config"])["system"] == "soa"
        assert {"scenario", "policy", "fan_seed_stride", "check_lanes_per_fan",
                "profile_launches", "warmup_seed_base", "warmup_fans_max"} <= set(mix)
