"""Plain reference of config 3 (``lidar20_full``): the tube world and its
lidar, wheel odometry, scan clustering, circle classification and the
hyperaccurate circle fit, and EKF-SLAM with first-hit Mahalanobis
association, in plain PyTorch.

It is written from the semantics of the reference C++ stack
(``nuturtlesim`` ``tube_world.cpp``, ``rigid2d``, ``nuslam``
``circle_fit_library.cpp`` and ``slam_library.cpp``), quirks included, as
the port states them. Everything is batch-first over worlds ``(W, ...)``,
in any dtype on any device; it imports nothing of the program. Every matrix
product goes through the ``mm`` each function takes (``torch.matmul`` by
default; ``arith.tf32_matmul`` for the control, the precision below
float32).

The check follows the program stage by stage (``portbench/drivers/
batch_lanes.py``): :func:`simulate` runs the worlds from the shared noise
(poses, odometry, twists) and :func:`lidar` gives the scan at a pose;
:func:`perceive` takes a scan and gives the detections; :func:`filter_run`
takes each tick's detections and gives the filter's poses and ``n_seen``.
The world and the filter also report, per world and tick, where one of
their discrete decisions came closer to its threshold than float32 can
resolve (a *tie*): there the decision may rightly go the other way in the
program, and what follows it is not compared.
"""

from __future__ import annotations

import math

import torch


# Decisions closer than these to their thresholds are ties (units of the
# quantity compared; each is far above float32's rounding of that quantity
# and far below the spread of the quantity over a run).
TIE_COLLISION_M = 1e-6      # robot-to-tube distance against the contact sum
TIE_GRAZE_M2 = 1e-5         # a ray's discriminant |p|^2 - r^2 near tangency
TIE_GATE_REL = 1e-3         # a Mahalanobis distance against a gate
TIE_WRAP_RAD = 1e-5         # a predicted bearing against +-pi


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


# ---------------------------------------------------------------------------
# World, lidar and odometry
# ---------------------------------------------------------------------------

def _wheels_to_twist(w, dl, dr):
    r, base = w["wheel_rad"], w["wheel_base"]
    return r / base * (dr - dl), r / 2.0 * (dl + dr)


def _drive(w, pose, wheels, new_wheels, mm):
    """Advance a diff-drive pose to new absolute wheel angles: the body
    twist of the wheel increments, integrated at constant velocity over
    unit time, rotated into the world frame by the current heading."""
    dth, dx = _wheels_to_twist(w, new_wheels[:, 0] - wheels[:, 0],
                               new_wheels[:, 1] - wheels[:, 1])
    small = dth.abs() < 1e-7
    safe = torch.where(small, torch.ones_like(dth), dth)
    s1 = torch.where(small, 1.0 - dth * dth / 6.0, torch.sin(safe) / safe)
    s2 = torch.where(small, dth / 2.0, (1.0 - torch.cos(safe)) / safe)
    body = torch.stack([dx * s1, dx * s2], -1)[..., None]       # (W, 2, 1)
    th = pose[:, 0]
    c, s = torch.cos(th), torch.sin(th)
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      -2)
    step = mm(rot, body)[..., 0]
    return torch.cat([(th + dth)[:, None], pose[:, 1:3] + step], -1)


def lidar(w, pose, normals, keep, mm=torch.matmul):
    """The scan at ``pose (W, 3)``: ray k at heading + 2 pi k / n, the
    nearest forward hit on any tube, ``scan_max + 1`` where none; noise on
    in-range rays, dropped rays at ``scan_max + 1``. Returns ``(ranges
    (W, n), graze (W, n))``: ``graze`` marks rays that pass within the
    tie distance of a tube's tangent, where hit or miss is a tie."""
    dt = pose.dtype
    n = w["num_rays"]
    tubes = torch.tensor(w["tubes"], dtype=dt, device=pose.device)
    k = torch.arange(n, dtype=dt, device=pose.device)
    ang = pose[:, 0:1] + 2.0 * math.pi * k / n
    u = torch.stack([torch.cos(ang), torch.sin(ang)], -1)     # (W, n, 2)
    p1 = pose[:, None, 1:3] - tubes[None]                     # (W, K, 2)
    b = mm(u, p1.transpose(-1, -2))                           # (W, n, K)
    c = p1.square().sum(-1)[:, None, :] - w["tube_rad"] ** 2
    disc = b * b - c                                          # (W, n, K)
    root = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1, t2 = -b - root, -b + root
    t = torch.where(t1 > 0, t1, t2)
    hit = (disc >= 0) & (t > 0)
    far = w["scan_max"] + 1.0
    ranges = torch.where(hit, t, torch.full_like(t, far)).amin(-1)
    near = (disc.abs() < TIE_GRAZE_M2) & (-b > 0)
    graze = near.any(-1)
    noisy = ranges + w["scan_noise"] * normals
    ranges = torch.where(ranges > w["scan_max"], ranges, noisy)
    ranges = torch.where(keep >= w["scan_dropout"], ranges,
                         torch.full_like(ranges, far))
    return ranges, graze


def simulate(w, noise, steps, mm=torch.matmul):
    """Run ``W`` worlds for ``steps`` ticks from rest at the origin under
    the constant command, from standard draws ``noise`` (a dict of
    ``twist``, ``slip`` ``(W, T, S, 2)``, ``scan``, ``scan_keep`` ``(W, T,
    n)``). Returns per tick ``true_pose``, ``odom_pose``, ``twist`` (the
    filter's odometry twist) ``(W, T, 3)``, the scan ``(W, T, n)``, and
    ``tie`` ``(W, T)`` bool where a collision test was a tie."""
    dt = noise["twist"].dtype
    dev = noise["twist"].device
    W = noise["twist"].shape[0]
    S = w["sim_substeps"]
    h = w["dt"]
    cw, cv = w["command"]
    half = w["wheel_base"] / 2.0
    r = w["wheel_rad"]
    contact = w["tube_rad"] + w["robot_rad"]
    tubes = torch.tensor(w["tubes"], dtype=dt, device=dev)
    slip_mean = (w["slip_min"] + w["slip_max"]) / 2.0
    slip_sd = w["slip_max"] - slip_mean

    z3 = lambda: torch.zeros((W, 3), dtype=dt, device=dev)
    z2 = lambda: torch.zeros((W, 2), dtype=dt, device=dev)
    pose, wheels, cmd_wheels = z3(), z2(), z2()
    odom, odom_wheels = z3(), z2()
    out = {k: [] for k in ("true_pose", "odom_pose", "twist", "scan",
                           "tie")}
    for t in range(steps):
        tie = torch.zeros(W, dtype=torch.bool, device=dev)
        for s in range(S):
            tn = w["twist_noise"] * noise["twist"][:, t, s]
            om, v = cw + tn[:, 0], cv + tn[:, 1]
            delta = tubes[None] - pose[:, None, 1:3]          # (W, K, 2)
            dist = torch.clamp_min(delta.square().sum(-1).sqrt(), 1e-9)
            tie |= ((dist - contact).abs() < TIE_COLLISION_M).any(-1)
            hitc = dist <= contact
            mv = torch.stack([delta[..., 1], -delta[..., 0]], -1) / dist[
                ..., None]
            nudge = torch.where(hitc[..., None], mv * (1.0 / 50.0),
                                torch.zeros_like(mv)).sum(1)
            pose = pose + torch.cat([torch.zeros_like(nudge[:, :1]), nudge],
                                    -1)
            u = torch.stack([-(half / r) * om + v / r,
                             (half / r) * om + v / r], -1)
            cmd_wheels = cmd_wheels + u * h
            eta = slip_mean + slip_sd * noise["slip"][:, t, s]
            new_wheels = cmd_wheels + u * eta
            pose = _drive(w, pose, wheels, new_wheels, mm)
            wheels = new_wheels
        scan, _ = lidar(w, pose, noise["scan"][:, t],
                        noise["scan_keep"][:, t], mm)
        dth, dx = _wheels_to_twist(w, cmd_wheels[:, 0] - odom_wheels[:, 0],
                                   cmd_wheels[:, 1] - odom_wheels[:, 1])
        odom = _drive(w, odom, odom_wheels, cmd_wheels, mm)
        odom_wheels = cmd_wheels
        for k, v in (("true_pose", pose), ("odom_pose", odom),
                     ("twist", torch.stack([dth, dx, torch.zeros_like(dx)],
                                           -1)),
                     ("scan", scan), ("tie", tie)):
            out[k].append(v)
    return {k: torch.stack(v, 1) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Perception: clustering, classification, circle fit
# ---------------------------------------------------------------------------

def _clusters(p, ranges):
    """The padded point buffer of each scan: clusters close where an
    in-range ray's next ray (wrapping, in range or not) jumps by the split
    threshold or more; out-of-range rays neither split nor join; the
    trailing open cluster is dropped, except that ray n-1, in range and not
    splitting, joins the end of cluster 0. Points at integer-degree body
    angles. Returns ``(points (W, C, P, 2), counts (W, C), valid (W,
    C))``."""
    W, n = ranges.shape
    C, P = p["max_clusters"], p["max_cluster_points"]
    dev, dt = ranges.device, ranges.dtype
    lo, hi, thr = p["scan_min"], p["scan_max"], p["split_threshold"]
    inr = (ranges >= lo) & (ranges <= hi)
    jump = (ranges - torch.roll(ranges, -1, dims=-1)).abs()
    split = inr & (jump >= thr)

    cum = torch.cumsum(split.long(), -1)
    cid = cum - split.long()
    closed = cum[:, -1]
    member = inr & (cid < closed[:, None])
    wrap_move = inr[:, -1] & ~split[:, -1] & (closed > 0)
    member[:, -1] &= ~wrap_move

    ang = (math.pi / 180.0) * (torch.arange(n, device=dev, dtype=dt)
                               * (360.0 / n))
    pts = torch.stack([ranges * torch.cos(ang), ranges * torch.sin(ang)], -1)
    onehot = (cid[..., None] == torch.arange(C, device=dev)) & member[
        ..., None]
    pos = (torch.cumsum(onehot.long(), 1) - onehot.long()).gather(
        -1, cid.clamp(0, C - 1)[..., None])[..., 0]
    counts = onehot.long().sum(1)
    slot = torch.where(member & (cid < C) & (pos < P), cid * P + pos,
                       torch.full_like(cid, C * P))
    buf = torch.zeros((W, C * P + 1, 2), dtype=dt, device=dev)
    buf.scatter_(1, slot[..., None].expand(W, n, 2), pts)
    points = buf[:, :C * P].reshape(W, C, P, 2)
    # ray n-1 appended to cluster 0 (a full cluster 0 loses its last row)
    at = torch.clamp_max(counts[:, 0], P - 1)
    rows = torch.arange(P, device=dev)[None] == at[:, None]
    put = wrap_move[:, None] & rows
    points[:, 0] = torch.where(put[..., None], pts[:, -1][:, None],
                               points[:, 0])
    counts[:, 0] += wrap_move.long()
    valid = (torch.arange(C, device=dev)[None] < closed[:, None]) & (
        counts >= 3)
    return points, counts, valid


def _is_circle(p, points, counts, valid):
    """Inscribed-angle test: the angle at each interior point between the
    cluster's first and last points, in degrees; a circle where their
    population std is under the threshold."""
    P = points.shape[-2]
    dev, dt = points.device, points.dtype
    first = points[:, :, 0]
    last = points.gather(2, (counts - 1).clamp(0, P - 1)[..., None, None]
                         .expand(*counts.shape, 1, 2))[:, :, 0]
    x1, y1 = points[..., 0], points[..., 1]
    x2, y2 = first[..., 0:1], first[..., 1:2]
    x3, y3 = last[..., 0:1], last[..., 1:2]
    num = y2 * (x1 - x3) + y1 * (x3 - x2) + y3 * (x2 - x1)
    den = (x2 - x1) * (x1 - x3) + (y2 - y1) * (y1 - y3)
    angles = torch.atan2(num, den) * (180.0 / math.pi)
    pos = torch.arange(P, device=dev)
    interior = (pos >= 1) & (pos <= counts[..., None] - 2)
    cnt = interior.sum(-1).clamp_min(1).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    mean = torch.where(interior, angles, zero).sum(-1) / cnt
    std = (torch.where(interior, (angles - mean[..., None]) ** 2, zero)
           .sum(-1) / cnt).sqrt()
    return valid & (counts >= 3) & (std < p["std_threshold_deg"])


def _eigh(A):
    """``torch.linalg.eigh`` of a batch of small symmetric matrices, on the
    host in their dtype (the card's batched solver bounds the batch)."""
    lam, vec = torch.linalg.eigh(A.cpu())
    return lam.to(A.device), vec.to(A.device)


def _fit(points, counts, valid, mm):
    """Hyperaccurate algebraic circle fit (Al-Sharadqah and Chernov) of
    each cluster: centroid shift, ``Z = [x^2 + y^2, x, y, 1]``, ``M = Z^T
    Z``; where the smallest singular value of Z is under 1e-12 the fit is
    its right singular vector, else ``Y = V S V^T``, ``Q = Y H^-1 Y`` and
    ``A = Y^-1 A*`` with ``A*`` the eigenvector of Q's smallest positive
    eigenvalue. Returns ``(center, radius, ok)``."""
    W, C, P, _ = points.shape
    dev, dt = points.device, points.dtype
    mask = torch.arange(P, device=dev) < counts[..., None]
    nn = counts.clamp_min(1).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    cx = torch.where(mask, points[..., 0], zero).sum(-1) / nn
    cy = torch.where(mask, points[..., 1], zero).sum(-1) / nn
    x = torch.where(mask, points[..., 0] - cx[..., None], zero)
    y = torch.where(mask, points[..., 1] - cy[..., None], zero)
    z = x * x + y * y
    Z = torch.stack([z, x, y, mask.to(dt)], -1)                # (W,C,P,4)
    M = mm(Z.transpose(-1, -2), Z)
    zbar = z.sum(-1) / nn
    Hinv = torch.zeros((W, C, 4, 4), dtype=dt, device=dev)
    Hinv[..., 0, 3] = Hinv[..., 3, 0] = 0.5
    Hinv[..., 1, 1] = Hinv[..., 2, 2] = 1.0
    Hinv[..., 3, 3] = -2.0 * zbar
    live = valid & (counts >= 4) & torch.isfinite(M).all(-1).all(-1)
    Msafe = torch.where(live[..., None, None], M,
                        torch.eye(4, dtype=dt, device=dev))
    lam, V = _eigh(Msafe)
    s = lam.clamp_min(0.0).sqrt()
    rank_def = s[..., 0] < 1e-12
    Y = mm(V * s[..., None, :], V.transpose(-1, -2))
    Q = mm(mm(Y, Hinv), Y)
    Q = 0.5 * (Q + Q.transpose(-1, -2))
    eq, EV = _eigh(Q)
    big = torch.where(eq > 0, eq, torch.full_like(eq, math.inf))
    k = big.argmin(-1)
    Astar = EV.gather(-1, k[..., None, None].expand(W, C, 4, 1))[..., 0]
    eye = torch.eye(4, dtype=dt, device=dev)
    Ysafe = Y + rank_def.to(dt)[..., None, None] * eye
    A = torch.linalg.solve(Ysafe, Astar)
    A = torch.where(rank_def[..., None], V[..., :, 0], A)
    A0_, A1, A2, A3 = A.unbind(-1)
    A0 = torch.where(A0_.abs() < 1e-30, torch.full_like(A0_, 1e-30), A0_)
    a, b = -A1 / (2.0 * A0), -A2 / (2.0 * A0)
    R2 = (A1 * A1 + A2 * A2 - 4.0 * A0_ * A3) / (4.0 * A0 * A0)
    radius = R2.clamp_min(0.0).sqrt()
    center = torch.stack([a + cx, b + cy], -1)
    ok = live & torch.isfinite(center).all(-1) & torch.isfinite(radius)
    return center, radius, ok


def perceive(p, ranges, mm=torch.matmul):
    """Detections of scans ``ranges (W, n)``: circle clusters whose fit is
    valid and whose radius is within ``max_radius``, compacted in cluster
    order, as ``zs (W, C, 2)`` = (range, bearing) and ``valid (W, C)``,
    and ``live (W, C)``: the cluster slots that hold a cluster to fit (a
    real cluster of four points or more)."""
    points, counts, valid = _clusters(p, ranges)
    circle = _is_circle(p, points, counts, valid)
    center, radius, fit_ok = _fit(points, counts, valid, mm)
    ok = circle & fit_ok & (radius <= p["max_radius"])
    C = ok.shape[-1]
    slot = torch.arange(C, device=ok.device)
    order = torch.argsort(torch.where(ok, slot, C), dim=-1, stable=True)
    pos = center.gather(1, order[..., None].expand(*order.shape, 2))
    valid_out = ok.gather(1, order)
    zs = torch.stack([pos.square().sum(-1).sqrt(),
                      wrap(torch.atan2(pos[..., 1], pos[..., 0]))], -1)
    return zs, valid_out, valid & (counts >= 4)


# ---------------------------------------------------------------------------
# The filter: EKF-SLAM, first-hit association, analytic first observation
# ---------------------------------------------------------------------------

def _inv2(S):
    a, b, c, d = S[..., 0, 0], S[..., 0, 1], S[..., 1, 0], S[..., 1, 1]
    det = a * d - b * c
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    return torch.stack([torch.stack([d, -b], -1),
                        torch.stack([-c, a], -1)], -2) / det[..., None, None]


def _jacobian(mean, j, D):
    """H (W, ..., 2, D) of the range-bearing measurement of slot(s) ``j``
    (W, ...) and the predicted measurement (W, ..., 2)."""
    mx = mean.gather(-1, (3 + 2 * j).reshape(j.shape[0], -1)).reshape(
        j.shape)
    my = mean.gather(-1, (4 + 2 * j).reshape(j.shape[0], -1)).reshape(
        j.shape)
    ex = (lambda v: v.reshape(v.shape[0], *[1] * (j.dim() - 1)))
    dx, dy = mx - ex(mean[:, 1]), my - ex(mean[:, 2])
    q = (dx * dx + dy * dy).clamp_min(1e-12)
    sq = q.sqrt()
    H = torch.zeros((*j.shape, 2, D), dtype=mean.dtype, device=mean.device)
    lane = torch.arange(D, device=mean.device)
    at = lambda k: (lane == k[..., None]).to(mean.dtype)
    cx, cy = at(3 + 2 * j), at(4 + 2 * j)
    H[..., 0, 1] = -dx / sq
    H[..., 0, 2] = -dy / sq
    H[..., 0, :] += (dx / sq)[..., None] * cx + (dy / sq)[..., None] * cy
    H[..., 1, 0] = -1.0
    H[..., 1, 1] = dy / q
    H[..., 1, 2] = -dx / q
    H[..., 1, :] += (-dy / q)[..., None] * cx + (dx / q)[..., None] * cy
    zhat = torch.stack([sq, wrap(torch.atan2(dy, dx) - ex(mean[:, 0]))], -1)
    return H, zhat


def filter_run(f, twists, zs, valid, mm=torch.matmul):
    """Run the filter over ``T`` ticks of ``W`` worlds from the origin:
    ``twists (W, T, 3)``, detections ``zs (W, T, C, 2)`` with ``valid (W,
    T, C)``. Each tick: the arc motion model's predict, then each valid
    detection in order: first-hit association over the seen landmarks
    (the first whose Mahalanobis distance is under ``new_gate``; a match
    if that one is under ``match_gate``, else skipped; new where none is),
    an analytic first-observation init for a new landmark, a symmetrized
    Kalman update for a match; a new landmark beyond capacity stops the
    tick. Returns ``slam_pose (W, T, 3)``, ``n_seen (W, T)`` and ``tie (W,
    T)`` where a gate or a bearing wrap was a tie."""
    W, T, C, _ = zs.shape
    dt, dev = zs.dtype, zs.device
    N = f["num_landmarks"]
    D = 3 + 2 * N
    Q = torch.zeros((D, D), dtype=dt, device=dev)
    Q[:3, :3] = torch.diag(torch.tensor(f["q_diag"], dtype=dt, device=dev))
    R = torch.diag(torch.tensor(f["r_diag"], dtype=dt, device=dev))
    g_match, g_new = f["match_gate"], f["new_gate"]
    mean = torch.zeros((W, D), dtype=dt, device=dev)
    P = torch.diag(torch.cat([torch.zeros(3, dtype=dt, device=dev),
                              torch.full((2 * N,), float(f["init_cov"]),
                                         dtype=dt, device=dev)])
                   ).expand(W, D, D).clone()
    n_seen = torch.zeros(W, dtype=torch.long, device=dev)
    seen = torch.zeros((W, N), dtype=torch.bool, device=dev)
    eye = torch.eye(D, dtype=dt, device=dev)
    wsel = lambda c, a, b: torch.where(
        c.reshape(W, *[1] * (a.dim() - 1)), a, b)
    poses, counts, ties = [], [], []
    for t in range(T):
        dth, dx = twists[:, t, 0], twists[:, t, 1]
        th = mean[:, 0]
        small = dth.abs() < 1e-7
        ratio = dx / torch.where(small, torch.ones_like(dth), dth)
        s0, c0 = torch.sin(th), torch.cos(th)
        s1, c1 = torch.sin(th + dth), torch.cos(th + dth)
        mean = mean.clone()
        mean[:, 0] += dth
        mean[:, 1] += torch.where(small, dx * c0, ratio * (s1 - s0))
        mean[:, 2] += torch.where(small, dx * s0, ratio * (c0 - c1))
        A = eye.expand(W, D, D).clone()
        A[:, 1, 0] += torch.where(small, -dx * s0, ratio * (c1 - c0))
        A[:, 2, 0] += torch.where(small, dx * c0, ratio * (s1 - s0))
        P = mm(mm(A, P), A.transpose(-1, -2)) + Q
        tie = torch.zeros(W, dtype=torch.bool, device=dev)
        stopped = torch.zeros(W, dtype=torch.bool, device=dev)
        for k in range(C):
            z = zs[:, t, k]
            act = valid[:, t, k] & ~stopped
            # association over every slot
            j_all = torch.arange(N, device=dev).expand(W, N)
            H, zhat = _jacobian(mean, j_all, D)                 # (W,N,2,D)
            S = mm(mm(H, P[:, None]), H.transpose(-1, -2)) + R
            dz = z[:, None] - zhat
            dist = (dz[..., None, :] @ _inv2(S) @ dz[..., None])[..., 0, 0]
            dist = torch.where(seen, dist, torch.full_like(dist, math.inf))
            rel = torch.minimum((dist - g_match).abs() / g_match,
                                (dist - g_new).abs() / g_new)
            wrap_m = math.pi - zhat[..., 1].abs()
            near = ((rel < TIE_GATE_REL) | (wrap_m < TIE_WRAP_RAD)) & seen
            tie |= act & near.any(-1)
            under = dist < g_new
            any_hit = under.any(-1)
            first = torch.where(under, torch.arange(N, device=dev),
                                N).amin(-1).clamp_max(N - 1)
            d_first = dist.gather(-1, first[:, None])[:, 0]
            match = act & (n_seen > 0) & any_hit & (d_first < g_match)
            full = n_seen >= N
            new = act & ((n_seen == 0) | ~any_hit) & ~full
            stopped |= act & ((n_seen == 0) | ~any_hit) & full
            # analytic init of slot n_seen
            j = n_seen.clamp_max(N - 1)
            a = z[:, 1] + mean[:, 0]
            r = z[:, 0]
            sa, ca = torch.sin(a), torch.cos(a)
            one, zero = torch.ones_like(r), torch.zeros_like(r)
            Gx = torch.stack([torch.stack([-r * sa, one, zero], -1),
                              torch.stack([r * ca, zero, one], -1)], -2)
            Gz = torch.stack([torch.stack([ca, -r * sa], -1),
                              torch.stack([sa, r * ca], -1)], -2)
            cross = mm(Gx, P[:, :3, :])                          # (W,2,D)
            block = (mm(mm(Gx, P[:, :3, :3]), Gx.transpose(-1, -2))
                     + mm(mm(Gz, R), Gz.transpose(-1, -2)))
            lane = torch.arange(D, device=dev)
            r0, r1 = 3 + 2 * j, 4 + 2 * j
            in0 = (lane == r0[:, None])
            in1 = (lane == r1[:, None])
            ins = in0 | in1
            Pn = torch.where(ins[:, :, None], torch.zeros_like(P), P)
            Pn = torch.where(ins[:, None, :], torch.zeros_like(P), Pn)
            rowv = (in0[:, :, None] * cross[:, None, 0, :]
                    + in1[:, :, None] * cross[:, None, 1, :])
            rowv = torch.where(ins[:, None, :], torch.zeros_like(P), rowv)
            Pn = Pn + rowv + rowv.transpose(-1, -2)
            Pn = Pn + (in0[:, :, None] * in0[:, None, :] * block[:, 0, 0, None,
                                                                 None]
                       + in0[:, :, None] * in1[:, None, :] * block[:, 0, 1,
                                                                   None, None]
                       + in1[:, :, None] * in0[:, None, :] * block[:, 1, 0,
                                                                   None, None]
                       + in1[:, :, None] * in1[:, None, :] * block[:, 1, 1,
                                                                   None, None])
            mn = mean.clone()
            mn[torch.arange(W, device=dev), r0] = mean[:, 1] + r * ca
            mn[torch.arange(W, device=dev), r1] = mean[:, 2] + r * sa
            mean = wsel(new, mn, mean)
            P = wsel(new, Pn, P)
            seen = seen | (new[:, None] & (torch.arange(N, device=dev)
                                           == j[:, None]))
            n_seen = n_seen + new.long()
            # Kalman update against the first hit
            H1, zh1 = _jacobian(mean, first, D)                  # (W,2,D)
            SHt = mm(P, H1.transpose(-1, -2))                    # (W,D,2)
            S1 = mm(H1, SHt) + R
            K = mm(SHt, _inv2(S1))
            mu = mean + mm(K, (z - zh1)[..., None])[..., 0]
            mu[:, 0] = wrap(mu[:, 0])
            KS = mm(K, SHt.transpose(-1, -2))
            Pu = P - 0.5 * (KS + KS.transpose(-1, -2))
            mean = wsel(match, mu, mean)
            P = wsel(match, Pu, P)
        poses.append(mean[:, :3])
        counts.append(n_seen)
        ties.append(tie)
    return (torch.stack(poses, 1), torch.stack(counts, 1),
            torch.stack(ties, 1))


# ---------------------------------------------------------------------------
# The judge: the reference follows each stage from the stage before it
# ---------------------------------------------------------------------------

# A detection differs where its range (m) or bearing (rad) is further than
# this from the reference's on the same scan: 100x float32's error of a fit
# (~1e-6), 1/5 of TF32's.
DET_TOL = 1e-4


def judge(cfg, noise, outs, dtype=torch.float64):
    """Hold ``outs`` (the program's, or the control's, for ``W`` worlds and
    ``T`` ticks: ``true_pose``, ``odom_pose``, ``slam_pose`` ``(W, T, 3)``,
    ``n_seen (W, T)``, ``scan (W, T, n)``, ``zs (W, T, C, 2)``, ``valid
    (W, T, C)``) against the reference in ``dtype``, stage by stage: the
    world and odometry from the shared ``noise``; the scan at the judged
    run's own true pose; the detections of its own scan; the filter on its
    own detections. Returns the numbers compared, by name, and
    ``live_cluster_share``, the share of cluster slots that hold a cluster
    to fit (the work the fit kernel's roofline counts)."""
    w, p, f = cfg["world"], cfg["perception"], cfg["filter"]
    cast = lambda x: x.to(dtype)
    nz = {k: cast(v) for k, v in noise.items()}
    W, T = outs["n_seen"].shape
    n = outs["scan"].shape[-1]
    sim = simulate(w, nz, T)

    def angle_gap(a, b):
        d = (cast(a) - b).abs()
        d[..., 0] = wrap(cast(a)[..., 0] - b[..., 0]).abs()
        return d.amax(-1)
    pre = torch.cumsum(sim["tie"].long(), 1) == 0
    pose_gap = torch.maximum(angle_gap(outs["true_pose"], sim["true_pose"]),
                             angle_gap(outs["odom_pose"], sim["odom_pose"]))
    pose_gap = torch.where(pre, pose_gap, torch.zeros_like(pose_gap)).max()

    scan, graze = lidar(w, cast(outs["true_pose"]).reshape(-1, 3),
                        nz["scan"].reshape(-1, n),
                        nz["scan_keep"].reshape(-1, n))
    scan, graze = scan.reshape(W, T, n), graze.reshape(W, T, n)
    mine = cast(outs["scan"])
    far = w["scan_max"] + 1.0
    hit_r, hit_p = scan < far, mine < far
    both = hit_r & hit_p & ~graze
    scan_gap = (torch.where(both, (mine - scan).abs(), torch.zeros_like(scan))
                .sum() / both.sum().clamp_min(1))
    scan_mismatch = ((hit_r != hit_p) & ~graze).sum()

    zs, valid, live = perceive(p, mine.reshape(-1, n))
    C = zs.shape[-2]
    zs, valid = zs.reshape(W, T, C, 2), valid.reshape(W, T, C)
    dz = (cast(outs["zs"]) - zs).abs()
    dz[..., 1] = wrap(cast(outs["zs"])[..., 1] - zs[..., 1]).abs()
    far_det = torch.where(valid[..., None], dz,
                          torch.zeros_like(dz)).amax((-1, -2)) > DET_TOL
    differ = (valid != outs["valid"]).any(-1) | far_det

    pose, n_seen, tie = filter_run(f, sim["twist"], cast(outs["zs"]),
                                   outs["valid"])
    pre = torch.cumsum(tie.long(), 1) == 0
    slam_gap = angle_gap(outs["slam_pose"], pose)
    slam_gap = torch.where(pre, slam_gap, torch.zeros_like(slam_gap)).max()
    n_seen_mismatch = ((n_seen != outs["n_seen"].long()) & pre).sum()
    f64 = lambda x: float(x)
    return {"pose_gap_m": f64(pose_gap), "scan_gap_m": f64(scan_gap),
            "scan_hit_mismatch": int(scan_mismatch),
            "detections_differ_share": f64(differ.double().mean()),
            "slam_gap_m": f64(slam_gap),
            "n_seen_mismatch": int(n_seen_mismatch),
            "filter_compared_share": f64(pre.double().mean()),
            "live_cluster_share": f64(live.double().mean())}


def control(cfg, noise, steps, mm):
    """The reference in the program's place, in float32 with matrix
    products ``mm`` (TF32 for the control): the same outputs as the
    program's for :func:`judge`."""
    w, p, f = cfg["world"], cfg["perception"], cfg["filter"]
    nz = {k: v.float() for k, v in noise.items()}
    sim = simulate(w, nz, steps, mm)
    W, T, n = sim["scan"].shape
    zs, valid, _ = perceive(p, sim["scan"].reshape(-1, n), mm)
    C = zs.shape[-2]
    zs, valid = zs.reshape(W, T, C, 2), valid.reshape(W, T, C)
    pose, n_seen, _ = filter_run(f, sim["twist"], zs, valid, mm)
    return {"true_pose": sim["true_pose"], "odom_pose": sim["odom_pose"],
            "slam_pose": pose, "n_seen": n_seen, "scan": sim["scan"],
            "zs": zs, "valid": valid}
