"""Training/eval telemetry — the reference's wandb / tensorboardX hooks
(trainer.py:39-66, 185-198, 249-257; tools/test.py:97-103, 270-286)
behind one config-gated facade (counterpart of
instaorder_tpu/utils/telemetry.py, copied whole).

When `wandb: True` is configured and the wandb client is not
importable, the run is captured in an OFFLINE run directory in wandb's
own layout — `<folder>/wandb/run-<name>/` with `config.json`,
`history.jsonl` (one JSON object per log call, wandb's history file
format) and a rolling `summary.json` — so every scalar the reference
would have sent to the wandb service is kept locally for inspection or
scripted import later (`wandb sync` itself needs the
client's binary .wandb log, so the fallback is a local record, not a
sync spool). When wandb IS importable, the real client is used.
tensorboardX is the other sink; both are imported only when configured.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class OfflineWandbRun:
    """wandb-API-compatible local sink (`log`/`finish`), used when
    `wandb: True` is configured but the client is not importable.

    Mirrors the offline-run layout: history.jsonl is append-only with
    `_step`/`_timestamp` fields per record, summary.json holds the
    latest value per key, config.json the run config. The run dir is
    locally inspectable/importable (e.g. `wandb.Api` CSV ingest or a
    pandas read of history.jsonl); it is NOT a `wandb sync` target —
    sync needs the client's binary .wandb transaction log."""

    def __init__(self, folder: str, name: Optional[str] = None,
                 config=None, project: str = 'InstaOrder'):
        stamp = time.strftime('%Y%m%d_%H%M%S')
        safe = (name or 'run').replace(os.sep, '-').replace('/', '-')
        self.dir = os.path.join(folder, 'wandb', f'run-{stamp}-{safe}')
        os.makedirs(self.dir, exist_ok=True)
        self.project = project
        self._summary: dict = {}
        self._history = open(os.path.join(self.dir, 'history.jsonl'),
                             'a', buffering=1)
        if config is not None:
            with open(os.path.join(self.dir, 'config.json'), 'w') as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, data: dict, step: Optional[int] = None):
        # numbers stay numbers; anything the real client would accept
        # as rich media/config (str, dict, ...) is JSON-stringified
        # rather than raising (wandb.log allows mixed payloads)
        rec = {}
        for k, v in data.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = json.dumps(v, default=str)
        if step is not None:
            rec['_step'] = int(step)
        rec['_timestamp'] = time.time()
        self._history.write(json.dumps(rec) + '\n')
        self._summary.update(rec)
        with open(os.path.join(self.dir, 'summary.json'), 'w') as f:
            json.dump(self._summary, f, indent=2)

    def finish(self):
        if self._history is not None:
            self._history.close()
            self._history = None


class SummaryLogger:
    """Facade over tensorboardX SummaryWriter (+ wandb when importable).

    scalar(tag, value, step) mirrors the reference's tag conventions:
    'lr', 'train_<k>', 'val_<k>' for the Trainer (trainer.py:186-193,
    249-252) and 'val/<k>' style for the Tester (tools/test.py:276-286).
    """

    def __init__(self, tb_writer=None, wb_run=None):
        self._tb = tb_writer
        self._wb = wb_run

    @property
    def active(self) -> bool:
        return self._tb is not None or self._wb is not None

    def scalar(self, tag: str, value, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wb is not None:
            self._wb.log({tag: float(value)}, step=step)

    def scalars(self, tags_values: dict, step: int):
        for k, v in tags_values.items():
            self.scalar(k, v, step)

    def flush(self):
        if self._tb is not None:
            # tensorboardX's flush() writes the FILE but does not drain
            # the async event queue (EventFileWriter._event_queue is
            # consumed by a worker thread) — scalars added just before
            # flush() can still be in flight. Drain it first so flush()
            # means "everything scalar()'d so far is on disk".
            import time
            writers = getattr(self._tb, 'all_writers', None) or {}
            for w in writers.values():
                q = getattr(getattr(w, 'event_writer', None),
                            '_event_queue', None)
                if q is None:
                    continue
                deadline = time.time() + 5.0
                while not q.empty() and time.time() < deadline:
                    time.sleep(0.01)
                # the worker may have popped the last event but not yet
                # handed it to the file writer; give it a beat
                time.sleep(0.05)
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._wb is not None:
            self._wb.finish()
            self._wb = None


def make_summary_logger(trainer_cfg: dict, folder: str,
                        run_name: Optional[str] = None,
                        config=None) -> SummaryLogger:
    """Config-gated construction, matching reference trainer.py:54-66:
    `wandb: True` wins over `tensorboard: True`; events go to
    <folder>/events."""
    tb_writer = None
    wb_run = None
    if trainer_cfg.get('wandb'):
        try:
            import wandb
        except ImportError:
            # no client / no egress: capture the run locally in wandb's
            # offline layout instead of dropping the capability
            wb_run = OfflineWandbRun(folder, run_name, config)
        else:
            wb_run = wandb.init(project='InstaOrder', name=run_name,
                                config=config)
    elif trainer_cfg.get('tensorboard'):
        try:
            from tensorboardX import SummaryWriter
        except ImportError as e:
            raise RuntimeError(
                'Please switch off "tensorboard" in your config file if '
                'you do not want to use it, otherwise install it.') from e
        tb_writer = SummaryWriter(os.path.join(folder, 'events'))
    return SummaryLogger(tb_writer, wb_run)
