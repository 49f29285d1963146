"""Role discovery of the PyTorch port: a copy of
``paddle_tpu/distributed/fleet/role_maker.py`` (pure Python): rank and role
from the launch contract's variables."""
from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2


class PaddleCloudRoleMaker:
    def __init__(self, is_collective: bool = True, **kwargs):
        self._is_collective = is_collective

    def _worker_index(self) -> int:
        return int(os.environ.get("PADDLE_GLOBAL_RANK",
                                  os.environ.get("PADDLE_TRAINER_ID", "0")))

    def _worker_num(self) -> int:
        return int(os.environ.get("PADDLE_WORLD_SIZE",
                                  os.environ.get("PADDLE_TRAINERS_NUM", "1")))

    def _is_first_worker(self) -> bool:
        return self._worker_index() == 0

    def _role(self):
        return Role.SERVER if os.environ.get("PADDLE_ROLE") == "server" \
            else Role.WORKER

    worker_index = _worker_index
    worker_num = _worker_num
    is_first_worker = _is_first_worker

    def _get_trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None, **kw):
        super().__init__()
        self._cur = current_id
        self._n = worker_num

    def _worker_index(self):
        return self._cur

    def _worker_num(self):
        return self._n

    worker_index = _worker_index
    worker_num = _worker_num
