"""The kernels' work against hand counts (PERF.md's kernel table)."""

from portbench import counts


def test_grid_update_at_the_edge():
    N, M = 32768, 8
    nbytes, flops = counts.grid_update_work(N, N, M)
    planes = 2 * 2 * N * N * 4 * 2          # four f32 planes, read + write
    assert planes == 34_359_738_368
    assert nbytes - planes == 520 * N       # the operands and op tables
    assert round(nbytes / 1e9, 2) == 34.38
    assert flops == 4 * N * N * 2 * 16      # 2M multiply-adds an element
    # memory-bound: 10.26 ms at 3.35 TB/s
    assert abs(counts.least_seconds(nbytes, flops) - 10.262e-3) < 1e-5


def test_grid_update_at_the_served_map():
    N, M = 50_000, 8
    nbytes, flops = counts.grid_update_work(N, N, M)
    assert nbytes == 32 * N * N + 520 * N   # 80.03 GB: 40 GB of planes
    assert round(nbytes / 1e9, 2) == 80.03
    # memory-bound: 23.89 ms at 3.35 TB/s
    assert abs(counts.least_seconds(nbytes, flops) - 23.888e-3) < 1e-5


def test_circle_fit_tail_at_config_3():
    C = 1024 * 16
    nbytes, flops = counts.circle_fit_tail_work(C, C)
    assert nbytes == 70 * C                 # 1.15 MB
    assert round(nbytes / 1e6, 2) == 1.15
    assert round(flops / 1e6) == 220        # 13,404 a cluster
    # bound by operations: 3.3 us
    assert abs(counts.least_seconds(nbytes, flops) - flops / 67e12) < 1e-12
    half = counts.circle_fit_tail_work(C, C // 2)
    assert half == (nbytes, flops // 2)


def test_ekf_tick_at_config_3():
    B, N, M = 65536, 20, 16
    D = 3 + 2 * N
    nbytes, flops = counts.ekf_tick_work(B, D, N, M)
    # state (cov, mean, n_seen, seen) read + written, twist, zs, valid read
    assert nbytes == B * (2 * (4 * D * D + 4 * D + 4 + N) + 12 + 8 * M + M) \
        + 52
    assert abs(nbytes / 1.005e9 - 1) < 0.01            # 1.005 GB
    # memory-bound: 0.300 ms at 3.35 TB/s, the busiest tick's operations
    # under it
    assert abs(counts.least_seconds(nbytes, flops) - 0.300e-3) < 1e-6
    assert flops / counts.F32_FLOPS_PER_S < nbytes / counts.HBM_BYTES_PER_S
