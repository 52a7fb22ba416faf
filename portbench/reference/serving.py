"""Plain reference of one robot served on a large map with known
association (BASELINE config 4's serving tick), in plain PyTorch.

The textbook EKF-SLAM the deferred blocked tick computes, written afresh:
a dense state ``[theta, x, y, landmarks in the order first seen]`` over
the landmarks seen so far (the rest of the map keeps its prior and no
cross-covariance, so it needs no storage), the arc motion model's predict,
and for each of a tick's measurements in order the analytic
first-observation init of a new landmark or the Kalman update of a seen
one. The update's covariance is the Joseph form, ``(I - KH) P (I - KH)^T +
K R K^T``, taken in O(D^2) as the plain downdate plus its first-order
correction: it equals the program's ``P - K S K^T`` in exact arithmetic and
keeps a long session's map positive-definite in float64, where the plain
downdate lost it after ~700-950 ticks on this map. It imports nothing of
the program; every matrix product goes through ``mm``
(``arith.tf32_matmul`` for the control).
"""

from __future__ import annotations

import torch


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


class Map:
    """The reference's state for ``capacity`` landmarks at most, on
    ``device`` in ``dtype``; :meth:`tick` applies one tick."""

    def __init__(self, n_landmarks: int, capacity: int, q_diag, r_diag,
                 init_cov: float, wrap_innovation: bool,
                 dtype=torch.float64, device="cpu", mm=torch.matmul):
        D = 3 + 2 * capacity
        kw = dict(dtype=dtype, device=device)
        self.mm = mm
        self.mean = torch.zeros(D, **kw)
        self.P = torch.zeros((D, D), **kw)
        self.Q = torch.diag(torch.tensor(q_diag, **kw))
        self.R = torch.diag(torch.tensor(r_diag, **kw))
        self.init_cov = init_cov
        self.wrap_innovation = wrap_innovation
        self.slot = torch.full((n_landmarks,), -1, dtype=torch.long)
        self.d = 3
        self.kw = kw

    def _predict(self, twist):
        dth, dx = float(twist[0]), float(twist[1])
        th = self.mean[0]
        small = abs(dth) < 1e-7
        ratio = dx / (1.0 if small else dth)
        s0, c0 = torch.sin(th), torch.cos(th)
        s1, c1 = torch.sin(th + dth), torch.cos(th + dth)
        if small:
            dq = torch.stack([dx * c0, dx * s0])
            b = torch.stack([-dx * s0, dx * c0])
        else:
            dq = torch.stack([ratio * (s1 - s0), ratio * (c0 - c1)])
            b = torch.stack([ratio * (c1 - c0), ratio * (s1 - s0)])
        self.mean[0] += dth
        self.mean[1:3] += dq
        A = torch.eye(3, **self.kw)
        A[1:3, 0] = b
        d = self.d
        self.P[:3, :d] = self.mm(A, self.P[:3, :d])
        self.P[:d, :3] = self.mm(self.P[:d, :3], A.T)
        self.P[:3, :3] += self.Q

    def _init(self, lid, z):
        """Analytic first observation (the infinite-prior limit): the mean
        from the robot pose, its cross-covariance ``Gx Sigma_r,:`` and own
        block ``Gx Srr Gx^T + Gz R Gz^T``."""
        d = self.d
        r, a = z[0], z[1] + self.mean[0]
        sa, ca = torch.sin(a), torch.cos(a)
        one, zero = torch.ones_like(r), torch.zeros_like(r)
        Gx = torch.stack([torch.stack([-r * sa, one, zero]),
                          torch.stack([r * ca, zero, one])])
        Gz = torch.stack([torch.stack([ca, -r * sa]),
                          torch.stack([sa, r * ca])])
        self.mean[d] = self.mean[1] + r * ca
        self.mean[d + 1] = self.mean[2] + r * sa
        cross = self.mm(Gx, self.P[:3, :d])
        self.P[d:d + 2, :d] = cross
        self.P[:d, d:d + 2] = cross.T
        self.P[d:d + 2, d:d + 2] = (
            self.mm(self.mm(Gx, self.P[:3, :3]), Gx.T)
            + self.mm(self.mm(Gz, self.R), Gz.T))
        self.slot[lid] = d
        self.d = d + 2

    def _update(self, j, z):
        d = self.d
        dx = self.mean[j] - self.mean[1]
        dy = self.mean[j + 1] - self.mean[2]
        q = torch.clamp_min(dx * dx + dy * dy, 1e-12)
        sq = q.sqrt()
        zero = torch.zeros_like(q)
        H5 = torch.stack([
            torch.stack([zero, -dx / sq, -dy / sq, dx / sq, dy / sq]),
            torch.stack([-torch.ones_like(q), dy / q, -dx / q, -dy / q,
                         dx / q])])
        cols = [0, 1, 2, j, j + 1]
        SHt = self.mm(self.P[:d, cols], H5.T)                   # (d, 2)
        S = self.mm(H5, SHt[cols]) + self.R
        a, b, c, e = S[0, 0], S[0, 1], S[1, 0], S[1, 1]
        Sinv = torch.stack([torch.stack([e, -b]), torch.stack([-c, a])]) / (
            a * e - b * c)
        K = self.mm(SHt, Sinv)
        zhat = torch.stack([sq, _wrap(torch.atan2(dy, dx) - self.mean[0])])
        dz = z - zhat
        if self.wrap_innovation:
            dz = torch.stack([dz[0], _wrap(dz[1])])
        self.mean[:d] += self.mm(K, dz[:, None])[:, 0]
        self.mean[0] = _wrap(self.mean[0])
        # Joseph form: with A = P - K (HP), (I - KH) P (I - KH)^T + K R K^T
        # = A - (A H^T - K R) K^T, and A H^T - K R is 0 in exact arithmetic
        self.P[:d, :d] -= self.mm(K, SHt.T)
        fix = self.mm(self.P[:d, cols], H5.T) - self.mm(K, self.R)
        self.P[:d, :d] -= self.mm(fix, K.T)

    def tick(self, twist, zs, ids):
        """One tick: ``twist (3,)``, ``zs (M, 2)``, ``ids (M,)`` (host
        tensors). Returns the pose ``[theta, x, y]``."""
        self._predict(twist)
        zs = zs.to(**self.kw)
        for k in range(zs.shape[0]):
            lid = int(ids[k])
            j = int(self.slot[lid])
            if j < 0:
                self._init(lid, zs[k])
            else:
                self._update(j, zs[k])
        return self.mean[:3].clone()

    def export(self, n_landmarks: int, row_ids) -> dict:
        """The state as the program lays it out, on the host: ``mean_m (N,
        2)`` (0 where unseen), ``seen (N,)``, ``n_seen``, ``cov_rr (3, 3)``,
        ``cov_rm (3, N, 2)``, ``diag4 (4, N)`` (own blocks, the prior on an
        unseen diagonal) and the covariance rows ``rows (R, 2, 2, N)`` of
        landmarks ``row_ids``: ``[i, p, q, m] = Sigma[(id_i, p), (m, q)]``."""
        N, kw, dev = n_landmarks, self.kw, self.kw["device"]
        seen = self.slot >= 0
        idx = seen.nonzero()[:, 0]
        s = self.slot[idx].to(dev)
        idx_d = idx.to(dev)
        mean_m = torch.zeros((N, 2), **kw)
        cov_rm = torch.zeros((3, N, 2), **kw)
        diag4 = torch.zeros((4, N), **kw)
        diag4[0] = diag4[3] = self.init_cov
        for q in range(2):
            mean_m[idx_d, q] = self.mean[s + q]
            cov_rm[:, idx_d, q] = self.P[:3][:, s + q]
            for p in range(2):
                diag4[2 * p + q, idx_d] = self.P[s + p, s + q]
        rows = torch.zeros((len(row_ids), 2, 2, N), **kw)
        for i, lid in enumerate(row_ids):
            j = int(self.slot[lid])
            if j < 0:
                rows[i, 0, 0, lid] = rows[i, 1, 1, lid] = self.init_cov
                continue
            for p in range(2):
                for q in range(2):
                    rows[i, p, q, idx_d] = self.P[j + p, s + q]
        host = lambda x: x.cpu()
        return {"mean_m": host(mean_m), "seen": seen,
                "n_seen": int(seen.sum()), "cov_rr": host(self.P[:3, :3]),
                "cov_rm": host(cov_rm), "diag4": host(diag4),
                "rows": host(rows)}


def replay(cfg: dict, run: dict, dtype, device, mm=torch.matmul):
    """The reference over a run's sessions, each from a fresh map: the pose
    after each tick of each session (host), and the last session's final
    state (:meth:`Map.export`)."""
    f = cfg["filter"]
    N = cfg["landmarks"]
    poses = []
    for s in run["sessions"]:
        ids = s["ids"].long()
        ref = Map(N, int(torch.unique(ids).numel()), f["q_diag"],
                  f["r_diag"], f["init_cov"], cfg["wrap_innovation"], dtype,
                  device, mm)
        poses.append(torch.stack([ref.tick(run["twist"], s["zs"][t], ids[t])
                                  for t in range(ids.shape[0])]).cpu())
    return poses, ref.export(N, run["row_ids"].tolist())


def judge(cfg: dict, run: dict, dtype=torch.float64, device="cpu") -> dict:
    """Hold a served run against the reference in ``dtype`` on ``device``:
    ``run`` has ``twist (3,)`` and its ``sessions``, each with its ticks'
    ``zs (T, M, 2)`` and ``ids (T, M)`` as handed over and the pose read
    back after each tick ``poses (T, 3)``; the last session's final state
    as :meth:`Map.export` gives it; and ``row_ids`` (host tensors).
    Returns the numbers compared, by name."""
    poses, want = replay(cfg, run, dtype, device)
    cast = lambda x: x.to(dtype=dtype, device="cpu")
    mine = torch.cat([cast(s["poses"]) for s in run["sessions"]])
    poses = torch.cat(poses)
    dp = (mine - poses).abs()
    dp[:, 0] = _wrap(mine[:, 0] - poses[:, 0]).abs()
    seen = want["seen"]
    N = seen.shape[0]

    def rel(name, mask):
        """max |program - reference| over ``mask`` against the reference's
        largest magnitude there."""
        w = want[name]
        d = torch.where(mask, (cast(run[name]) - w).abs(), 0.0).max()
        return float(d / torch.where(mask, w.abs(), 0.0).max()
                     .clamp_min(1e-300))

    row_seen = seen[run["row_ids"]]
    cov_gap = max(
        rel("rows", (row_seen[:, None, None, None]
                     & seen[None, None, None, :]).expand(-1, 2, 2, N)),
        rel("cov_rm", seen[None, :, None].expand(3, N, 2)),
        rel("cov_rr", torch.ones((3, 3), dtype=torch.bool)),
        rel("diag4", seen[None].expand(4, N)))
    # what was never seen keeps its prior exactly (as float32 holds it)
    f32 = lambda x: x.float().to(dtype)
    bad = int((cast(run["rows"])[~row_seen] != f32(want["rows"][~row_seen]))
              .sum())
    bad += int((cast(run["diag4"])[:, ~seen]
                != f32(want["diag4"][:, ~seen])).sum())
    bad += int((cast(run["cov_rm"])[:, ~seen] != 0).sum())
    bad += int((cast(run["mean_m"])[~seen] != 0).sum())
    return {"pose_gap": float(dp.max()),
            "landmark_gap_m": float(torch.where(
                seen[:, None], (cast(run["mean_m"]) - want["mean_m"]).abs(),
                0.0).max()),
            "cov_gap_rel": cov_gap,
            "seen_mismatch": abs(int(run["n_seen"]) - want["n_seen"])
            + int((run["seen"].cpu() != seen).sum()),
            "prior_mismatch": bad}


def control(cfg: dict, run: dict, mm, device="cpu") -> dict:
    """The reference in the program's place, in float32 with matrix
    products ``mm`` (TF32 for the control): a run as :func:`judge` takes
    it, on the same inputs and row ids, over the ticks before its state
    first holds a value that is not finite. TF32 loses the map's
    positive-definiteness within the run, and from there gives no number
    to compare; the stretch before it does, and the gaps only grow with
    the ticks, so its reading is the least the whole run would give.
    ``kept`` is the number of ticks of that stretch, over all sessions
    (``ValueError`` where it has none: no number)."""
    f = cfg["filter"]
    N = cfg["landmarks"]
    sessions, kept = [], 0
    for s in run["sessions"]:
        ids = s["ids"].long()
        ref = Map(N, int(torch.unique(ids).numel()), f["q_diag"],
                  f["r_diag"], f["init_cov"], cfg["wrap_innovation"],
                  torch.float32, device, mm)
        poses, lost = [], False
        for t in range(ids.shape[0]):
            before = (ref.mean.clone(), ref.P.clone(), ref.slot.clone(),
                      ref.d)
            pose = ref.tick(run["twist"], s["zs"][t], ids[t])
            d = ref.d
            if not (torch.isfinite(ref.mean[:d]).all()
                    and torch.isfinite(ref.P[:d, :d]).all()):
                ref.mean, ref.P, ref.slot, ref.d = before
                lost = True
                break
            poses.append(pose.cpu())
        kept += len(poses)
        sessions.append(dict(s, zs=s["zs"][:len(poses)],
                             ids=s["ids"][:len(poses)],
                             poses=torch.stack(poses) if poses
                             else torch.zeros((0, 3))))
        if lost:
            break
    if not kept:
        raise ValueError("the control lost its state on its first tick")
    state = ref.export(N, run["row_ids"].tolist())
    return dict(run, sessions=sessions, kept=kept, **state)
