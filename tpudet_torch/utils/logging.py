"""Root logger: counterpart of ``tpudet/utils/logging.py``.

One difference: tpudet's logger keeps the file of its first call, so a
second ``train_detector`` in the same process logs into the first one's
work dir. Here a call with another ``log_file`` moves the file handler
there (the console handler stays).
"""
from __future__ import annotations

import logging
import os.path as osp

_initialized = set()


def get_root_logger(log_file=None, log_level=logging.INFO,
                    name='tpudet') -> logging.Logger:
    logger = logging.getLogger(name)
    fmt = logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    if name not in _initialized:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.setLevel(log_level)
        logger.propagate = False
        _initialized.add(name)
    if log_file is not None:
        path = osp.abspath(log_file)
        files = [h for h in logger.handlers
                 if isinstance(h, logging.FileHandler)]
        if [h.baseFilename for h in files] != [path]:
            for h in files:
                logger.removeHandler(h)
                h.close()
            fh = logging.FileHandler(path, 'a')
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
