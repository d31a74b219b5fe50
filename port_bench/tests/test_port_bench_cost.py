"""The cost functions against counts made by hand at N = 4 (n = 24, K =
50, P = 6, 25 ADMM iterations, 2 Newton-Schulz iterations)."""

from port_bench.reference import cost


def test_phase1_cost_at_n4():
    c = cost.phase1_cost(4, 50, 25)
    # 25 iterations x 2N K = 400 static rows and channels x (40 + 75 + 78)
    assert c["fp32_flops"] == 25 * 400 * 193 == 1_930_000
    assert c["mm_flops"] == 0
    # 72 N K = 14,400 floats of the state, duals and bounds, 4 K P = 1,200
    # of the collision rows, 4 bytes each
    assert c["bytes"] == 62_400


def test_scp_qp_cost_at_n4():
    c = cost.scp_qp_cost(4, 50, 25, 2)
    # 46 interior steps x (2 x (2 x 24^3 + 24 x 25^2) + 13 x 24^2)
    assert c["mm_flops"] == 46 * (2 * (27_648 + 15_000) + 7_488) == 4_268_064
    # 4 exact steps x 14/3 x 24^3 = 258,048; 25 x (x-update 2 x 50 x 2 x
    # 576 = 115,200 + rows 400 x 52 + 400 x 75 + 300 x 15 = 55,300)
    assert c["fp32_flops"] == 258_048 + 25 * (115_200 + 55_300) == 4_520_548
    assert c["bytes"] == 4 * (14_400 + 1_800) == 64_800


def test_work_and_least_time():
    w = cost.work(4, 50, 25, 2, [0, 2, 1])
    one, qp = cost.phase1_cost(4, 50, 25), cost.scp_qp_cost(4, 50, 25, 2)
    assert w == {k: 3 * one[k] + 3 * qp[k] for k in one}
    t = cost.least_seconds(w)
    assert t == max(w["bytes"] / 3.35e12, w["fp32_flops"] / 67e12,
                    w["mm_flops"] / 495e12)
    assert t == w["fp32_flops"] / 67e12
