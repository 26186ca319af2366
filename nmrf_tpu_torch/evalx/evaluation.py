"""Evaluation: disparity metrics + eval loop, the port's copy of
``nmrf_tpu/evalx/evaluation.py`` (reference ``nmrf/utils/evaluation.py``):
  * ``DispEvaluator``: per-sample EPE, D1 (>3px AND >5%), bad-t thresholds,
    plus proposal quality (prop_epe / prop_recall_3 / prop_recall_8) against
    superpixel-pooled 1/8 GT.
  * ``inference_on_dataset``: timed eval loop with warmup-aware ETA.

The proposal metric follows the reference *intent* (the snapshot's
``EVAL_PROP`` path is broken: no ``downsample_disp`` op and no
``super_pixel_label`` producer, SURVEY.md §2.1): per-cell min |pooled_gt -
8*proposal| over candidates, averaged over valid cells.  The superpixel
labels guiding the GT pooling come from the sample's
``super_pixel_label`` when present, else are generated on the fly from
the left image (``data/superpixel.py`` SLIC-lite); the plain valid-mean
pooling fallback only fires when no image is available either.

Metric math runs in numpy on the host, in float64 where numpy takes it,
as in the JAX package.
"""

import datetime
import logging
import time
from collections import OrderedDict

import numpy as np

from ..utils.logger import log_every_n_seconds

logger = logging.getLogger(__name__)


def print_csv_format(results, logger_=None):
    """csv-style result logging (reference evaluation.py:20-39)."""
    log = logger_ or logger
    for task, res in results.items():
        imp_keys = sorted(res.keys())
        log.info("copypaste: Task: {}".format(task))
        log.info("copypaste: " + ",".join([k[:10] for k in imp_keys]))
        log.info("copypaste: " + ",".join(["{0:.4f}".format(res[k]) for k in imp_keys]))


class DispEvaluator:
    def __init__(self, thres, only_valid, max_disp=None, eval_prop=True, divis_by=8):
        self._max_disp = np.inf if max_disp is None else max_disp
        self._thres = thres
        self._only_valid = only_valid
        self._eval_prop = eval_prop
        self._divis_by = divis_by
        self.reset()

    def reset(self):
        self._epe = []
        self._d1 = []
        self._thres_metric = OrderedDict()
        if self._thres is not None:
            for t in self._thres:
                self._thres_metric[t] = []
        self._prop_epe = []
        self._prop_recall_3 = []
        self._prop_recall_8 = []

    def process(self, inputs, outputs):
        """inputs/outputs: dicts of [B, ...] numpy arrays (B small)."""
        B = np.asarray(outputs["disp"]).shape[0]
        for b in range(B):
            disp_pr = np.asarray(outputs["disp"][b])
            disp_gt = np.asarray(inputs["disp"][b])
            valid_gt = np.asarray(inputs["valid"][b]).astype(bool)
            valid = (valid_gt & (disp_gt < self._max_disp)) if self._only_valid \
                else (disp_gt < self._max_disp)
            assert disp_pr.shape == disp_gt.shape, (disp_pr.shape, disp_gt.shape)

            epe = np.abs(disp_pr - disp_gt).ravel()
            val = valid.ravel()
            if val.sum() == 0 or np.isnan(epe[val].mean()):
                continue
            self._epe.append(float(epe[val].mean()))
            gt_flat = disp_gt.ravel()
            self._d1.append(float(
                ((epe[val] > 3) & (epe[val] / np.maximum(gt_flat[val], 1e-12) > 0.05)).mean()))
            for t in self._thres_metric:
                self._thres_metric[t].append(float((epe[val] > float(t)).mean()))

            if self._eval_prop and "proposal" in outputs:
                sp = inputs.get("super_pixel_label")
                self._process_prop(
                    np.asarray(outputs["proposal"][b]) * 8.0, disp_gt, valid_gt,
                    np.asarray(sp[b]) if sp is not None else None,
                    np.asarray(inputs["img1"][b]) if "img1" in inputs else None)

    def _process_prop(self, proposal, disp_gt, valid_gt, sp_label, image=None):
        from ..ops.downsample import downsample_disp

        gt = np.where(valid_gt, disp_gt, 0.0)
        H, W = gt.shape
        h, w = H // 8, W // 8
        if sp_label is None and image is not None:
            from ..data.superpixel import slic_segments

            sp_label = slic_segments(image)
        if sp_label is not None:
            # numpy inputs keep the pooling on the host
            lab = np.asarray(sp_label)
            mini = downsample_disp(gt[None].astype(np.float32),
                                   lab[None])[0]
        else:
            # fallback: plain valid-mean pooling per 8x8 cell
            g = gt[: h * 8, : w * 8].reshape(h, 8, w, 8).transpose(0, 2, 1, 3).reshape(h, w, 64)
            v = (g > 0)
            cnt = v.sum(-1)
            mini = np.where(cnt > 0, g.sum(-1) / np.maximum(cnt, 1), 0.0)

        im_h = (H + self._divis_by - 1) // self._divis_by * self._divis_by // 8
        im_w = (W + self._divis_by - 1) // self._divis_by * self._divis_by // 8
        N = proposal.shape[-1]
        prop = proposal.reshape(im_h, im_w, N)[:h, :w].reshape(-1, N)
        mini = mini[:h, :w].reshape(-1)
        dist = np.abs(mini[:, None] - prop).min(axis=1)
        mask = (mini > 0) & (mini < self._max_disp)
        if mask.sum() == 0 or np.isnan(dist[mask].mean()):
            return
        self._prop_epe.append(float(dist[mask].mean()))
        self._prop_recall_3.append(float((dist[mask] <= 3).mean()))
        self._prop_recall_8.append(float((dist[mask] <= 8).mean()))

    def evaluate(self, gather_fn=None):
        """gather_fn: optional callable(list)->list-of-lists for multi-process
        aggregation (``utils.dist.metrics_gather_fn``)."""
        epe, d1 = self._epe, self._d1
        thres_metric = self._thres_metric
        prop_epe, pr3, pr8 = self._prop_epe, self._prop_recall_3, self._prop_recall_8
        if gather_fn is not None:
            epe = sum(gather_fn(epe), [])
            d1 = sum(gather_fn(d1), [])
            thres_metric = OrderedDict(
                (k, sum(gather_fn(v), [])) for k, v in thres_metric.items())
            prop_epe = sum(gather_fn(prop_epe), [])
            pr3 = sum(gather_fn(pr3), [])
            pr8 = sum(gather_fn(pr8), [])

        res = {"epe": float(np.mean(epe)) if epe else float("nan"),
               "d1": float(np.mean(d1)) * 100 if d1 else float("nan")}
        for k, v in thres_metric.items():
            res[f"bad {k}"] = float(np.mean(v)) * 100 if v else float("nan")
        if self._eval_prop and prop_epe:
            res["prop_epe"] = float(np.mean(prop_epe))
            res["prop_recall_3"] = float(np.mean(pr3)) * 100
            res["prop_recall_8"] = float(np.mean(pr8)) * 100
        return {"disp": res}


def inference_on_dataset(run_model, data_iter, evaluator, total=None,
                         gather_fn=None):
    """Timed eval loop (reference evaluation.py:166-289).

    Args:
      run_model: callable(sample_dict) -> output dict of numpy arrays
        (on the host, so the device work is done when it returns).
      data_iter: iterable of sample dicts with [B, ...] arrays.
      evaluator: DispEvaluator.
    """
    evaluator.reset()
    num_warmup = 5
    start_time = time.perf_counter()
    total_data_time = total_compute_time = total_eval_time = 0.0
    start_data_time = time.perf_counter()
    for idx, inputs in enumerate(data_iter):
        total_data_time += time.perf_counter() - start_data_time
        if idx == num_warmup:
            start_time = time.perf_counter()
            total_data_time = total_compute_time = total_eval_time = 0.0

        t0 = time.perf_counter()
        outputs = run_model(inputs)
        total_compute_time += time.perf_counter() - t0

        t0 = time.perf_counter()
        evaluator.process(inputs, outputs)
        total_eval_time += time.perf_counter() - t0

        iters_after_start = idx + 1 - num_warmup * int(idx >= num_warmup)
        compute_spi = total_compute_time / iters_after_start
        if idx >= num_warmup * 2 or compute_spi > 5:
            # throttled progress + ETA every 5 s (reference evaluation.py:239)
            seconds_per_iter = (time.perf_counter() - start_time) / iters_after_start
            eta = ""
            if total:
                eta = " ETA=" + str(datetime.timedelta(
                    seconds=int(seconds_per_iter * (total - idx - 1))))
            log_every_n_seconds(
                logging.INFO,
                f"Inference done {idx + 1}{f'/{total}' if total else ''}. "
                f"{compute_spi:.4f} s/iter compute, "
                f"{total_data_time / iters_after_start:.4f} s/iter data, "
                f"{seconds_per_iter:.4f} s/iter total.{eta}",
                n=5, name=__name__)
        start_data_time = time.perf_counter()

    return evaluator.evaluate(gather_fn=gather_fn)
