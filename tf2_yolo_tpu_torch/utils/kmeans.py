"""K-means anchor fitting: a vectorized version on tensors
(``kmeans_torch``, the port of the JAX package's ``kmeans_jax``) and the
NumPy compatibility/oracle path (``kmeans``, a copy of the JAX package's).

``kmeans`` exists for one purpose: drop-in determinism parity with
the reference (reference utils/kmeans.py:43-102) — the same RNG call
sequence under a seeded ``np.random`` yields the same anchors as a
seeded reference run (random init scaled by the data range,
argmin-assignment, empty clusters re-seeded randomly, loss = mean
distance between consecutive center sets). It is a faithful
transcription of that public algorithm, so it serves as the test oracle;
it is not the performance path.
"""

import numpy as np


def iou(center_boxes, data_boxes):
    """Area-ratio IoU approximation min(area)/max(area)
    (reference kmeans.py:9-24)."""
    center_area = center_boxes[..., 0] * center_boxes[..., 1]
    data_area = data_boxes[..., 0] * data_boxes[..., 1]
    return (np.minimum(center_area, data_area)
            / np.maximum(center_area, data_area))


def iou_dist(center_boxes, data_boxes):
    """1 - IoU (reference kmeans.py:27-33)."""
    return 1 - iou(center_boxes, data_boxes)


def euclidean_dist(center_boxes, data_boxes):
    """L2 distance (reference kmeans.py:36-40)."""
    return np.sqrt(np.sum(np.square(center_boxes - data_boxes), axis=-1))


def kmeans(data, n_cluster, dist_func, stop_dist,
           max_iternum=10000, verbose=True):
    """K-means clustering with a pluggable distance (reference
    kmeans.py:43-102).

    Args:
        data: (num_samples, num_dims) array.
        n_cluster: number of clusters.
        dist_func: distance of (n_cluster, 1, d) centers vs (1, N, d)
            data -> (n_cluster, N).
        stop_dist: stop when mean center displacement falls below this.
        max_iternum: iteration cap.
        verbose: print per-epoch loss.

    Returns:
        (n_cluster, num_dims) float32 centers.
    """
    data = np.asarray(data)
    n_dim = data.shape[-1]
    data = data[None, ...]                       # 1,N,d
    data_max, data_min = data.max(), data.min()

    center = (np.random.rand(n_cluster * n_dim)
              .reshape((n_cluster, 1, n_dim)) * data_max)
    center = center * (data_max - data_min) + data_min

    epoch = 1
    while True:
        assign = np.argmin(dist_func(center, data), axis=0)   # (N,)
        new_center = np.copy(center)
        for n in range(n_cluster):
            members = np.where(assign == n)[0]
            if len(members) > 0:
                new_center[n, 0] = data[0, members].mean(axis=0)
            else:
                new_center[n, 0] = (np.random.rand(n_dim)
                                    * (data_max - data_min) + data_min)
        loss = np.mean(dist_func(center, new_center))
        center = new_center
        if verbose:
            print(f"epoch {epoch:2d}: loss = {loss:.4f}")
        epoch += 1
        if loss < stop_dist or epoch > max_iternum:
            break

    return center.reshape((n_cluster, n_dim)).astype("float32")


def kmeans_torch(data, n_cluster, dist="iou", stop_dist=1e-4,
                 max_iternum=1000, seed=0, device="cuda"):
    """Vectorized k-means on the card (``device``; tests pass "cpu"):
    the Lloyd loop of the JAX package's ``kmeans_jax``, one assignment
    and update step on tensors per iteration, with a host-side
    convergence check on the mean absolute centre shift.

    ``dist`` is "iou" (anchor fitting) or "euclidean". The start is
    ``n_cluster`` distinct rows drawn with a ``torch.Generator`` seeded
    by ``seed``. Empty clusters keep their previous centre
    (deterministic, unlike the reference's random re-seed). Returns
    (n_cluster, d) float32 numpy.
    """
    import torch

    x = torch.as_tensor(np.asarray(data, np.float32), device=device)
    gen = torch.Generator().manual_seed(seed)
    pick = torch.randperm(x.shape[0], generator=gen)[:n_cluster]
    return _lloyd(x, x[pick.to(device)], dist, stop_dist, max_iternum)


def _lloyd(x, center, dist, stop_dist, max_iternum):
    """The Lloyd loop of ``kmeans_torch`` from the start ``center``
    ((k, d) tensor on ``x``'s device)."""
    import torch

    n_cluster = center.shape[0]

    def dist_fn(c):
        if dist == "iou":
            ca = c[:, None, 0] * c[:, None, 1]          # k,1
            xa = x[None, :, 0] * x[None, :, 1]          # 1,N
            return 1 - torch.minimum(ca, xa) / torch.maximum(ca, xa)
        diff = c[:, None, :] - x[None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1))

    for _ in range(max_iternum):
        assign = torch.argmin(dist_fn(center), dim=0)              # N
        one_hot = torch.nn.functional.one_hot(
            assign, n_cluster).to(torch.float32)                    # N,k
        counts = one_hot.sum(dim=0)                                 # k
        sums = one_hot.T @ x                                        # k,d
        new_center = torch.where(
            counts[:, None] > 0,
            sums / torch.clamp(counts[:, None], min=1.0), center)
        shift = float(torch.mean(torch.abs(new_center - center)))
        center = new_center
        if shift < stop_dist:
            break
    return center.cpu().numpy()
