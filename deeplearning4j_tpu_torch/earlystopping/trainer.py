"""Early-stopping trainers (port of
``deeplearning4j_tpu/earlystopping/trainer.py``; reference
``earlystopping/trainer/BaseEarlyStoppingTrainer.java``: train one epoch,
check the iteration conditions, score every N epochs, save the best,
check the epoch conditions)."""

from __future__ import annotations

from .. import monitor as _monitor
from .config import EarlyStoppingConfiguration, EarlyStoppingResult


class EarlyStoppingTrainer:
    """Epoch-driven training with termination conditions (reference
    ``BaseEarlyStoppingTrainer``)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, iterator):
        self.config = config
        self.net = net
        self.iterator = iterator

    def _fit_one_epoch(self) -> None:
        self.net.fit(self.iterator)

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        net = self.net
        net.init()
        result = EarlyStoppingResult()
        for cond in (cfg.epoch_termination_conditions
                     + cfg.iteration_termination_conditions):
            cond.initialize()

        epoch = 0
        while True:
            with _monitor.span("earlystopping/epoch", epoch=epoch):
                self._fit_one_epoch()
            _monitor.counter("earlystopping_epochs_total",
                             "early-stopping training epochs run").inc()

            # iteration conditions (time, divergence) on the latest score
            stop_iter = None
            for cond in cfg.iteration_termination_conditions:
                if cond.terminate(net.iteration, net.score()):
                    stop_iter = cond
                    break
            if stop_iter is not None:
                result.termination_reason = "IterationTerminationCondition"
                result.termination_details = str(stop_iter)
                break

            if epoch % cfg.evaluate_every_n_epochs == 0:
                score = (cfg.score_calculator.calculate_score(net)
                         if cfg.score_calculator else net.score())
                result.score_vs_epoch[epoch] = float(score)
                if score < result.best_model_score:
                    result.best_model_score = float(score)
                    result.best_model_epoch = epoch
                    _monitor.gauge("earlystopping_best_score",
                                   "best early-stopping model score so "
                                   "far").set(float(score))
                    if cfg.model_saver:
                        cfg.model_saver.save_best_model(net, score)
                    else:
                        result.best_model = net.clone()
                if cfg.save_last_model and cfg.model_saver:
                    cfg.model_saver.save_latest_model(net, score)

                stop_epoch = None
                for cond in cfg.epoch_termination_conditions:
                    if cond.terminate(epoch, float(score)):
                        stop_epoch = cond
                        break
                if stop_epoch is not None:
                    result.termination_reason = "EpochTerminationCondition"
                    result.termination_details = str(stop_epoch)
                    epoch += 1
                    break
            epoch += 1

        result.total_epochs = epoch
        if result.best_model is None and cfg.model_saver:
            result.best_model = cfg.model_saver.get_best_model()
        if result.best_model is None:
            result.best_model = net
        return result


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """Early stopping over data-parallel epochs (reference
    ``EarlyStoppingParallelTrainer.java``): an epoch is one
    ``ParallelWrapper.fit`` over the iterator.  ``devices`` lists one
    device a worker (default: every visible card)."""

    def __init__(self, config: EarlyStoppingConfiguration, net, iterator,
                 workers=None, averaging_frequency: int = 1,
                 average_updaters: bool = True, devices=None):
        super().__init__(config, net, iterator)
        from ..parallel.parallel_wrapper import ParallelWrapper
        self.wrapper = ParallelWrapper(
            net, workers=workers, averaging_frequency=averaging_frequency,
            average_updaters=average_updaters, devices=devices)

    def _fit_one_epoch(self) -> None:
        self.wrapper.fit(self.iterator)
