"""The benchmark's byte counts against values worked by hand."""
from h100bench import counts, peaks


def test_alloc_ladder_bytes_by_hand():
    # want 24 + entry 6 + part 12 + ladder 48 + budgets 16 + perm 24 + grants 24
    assert counts.alloc_ladder_bytes(R=2, W=3, C=4, P=2, part_rows=1, cand_rows=1,
                                     cap_rows=2) == 154
    # a per-lane ladder and part plane: 24 + 6 + 24 + 96 + 16 + 24 + 24
    assert counts.alloc_ladder_bytes(2, 3, 4, 2, 2, 2, 2) == 214


def test_start_keep_bytes_by_hand():
    # d 24 + part 24 + avail 8 + perm 24 + mask 6
    assert counts.start_keep_bytes(R=2, W=3, P=2, part_rows=2, avail_rows=1) == 86


def test_peaks_are_the_data_sheet_s():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
