"""Filesystem clients of the PyTorch port (the checkpointing substrate).

Counterpart of ``paddle_tpu/distributed/fleet/utils/fs.py``, whose code
is host Python and is kept here as it is: ``FS``, the errors, ``LocalFS``
over the host's file system and ``HDFSClient``, a client over the
``hadoop fs`` command line (the command lines Paddle's ``HDFSClient``
builds: ``{hadoop_home}/bin/hadoop fs ...``, or ``hadoop`` on ``PATH``
when ``hadoop_home`` is None). Without the program it raises
ExecuteError; the tests put a fake ``hadoop`` on ``PATH``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import time


class FSFileExistsError(IOError):
    pass


class FSFileNotExistsError(IOError):
    pass


class ExecuteError(IOError):
    pass


class FSTimeOut(IOError):
    pass


class FS:
    def ls_dir(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False):
        raise NotImplementedError

    def touch(self, path, exist_ok=True):
        raise NotImplementedError

    def cat(self, path):
        raise NotImplementedError

    def need_upload_download(self):
        return False


class LocalFS(FS):
    """The host's file system."""

    def ls_dir(self, path):
        if not os.path.exists(path):
            return [], []
        dirs, files = [], []
        for e in os.listdir(path):
            (dirs if os.path.isdir(os.path.join(path, e)) else files).append(e)
        return dirs, files

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def upload(self, local_path, fs_path):
        self.mkdirs(os.path.dirname(fs_path))
        shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        shutil.copy(fs_path, local_path)

    def mkdirs(self, path):
        if path:
            os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite=False):
        if not overwrite and os.path.exists(dst):
            raise FSFileExistsError(dst)
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path):
            if exist_ok:
                return
            raise FSFileExistsError(path)
        self.mkdirs(os.path.dirname(path))
        open(path, "a").close()

    def cat(self, path):
        with open(path, "rb") as f:
            return f.read().decode("utf-8", "replace")

    def list_dirs(self, path):
        dirs, _ = self.ls_dir(path)
        return dirs


class HDFSClient(FS):
    """HDFS client over the `hadoop fs` command line: `-ls`,
    `-test -d/-e`, `-put`, `-get`, `-mkdir -p`, `-mv`, `-rm -r`,
    `-touchz`, `-cat`, each retried up to 3 times. The `hadoop` program
    comes from hadoop_home/bin, or PATH when hadoop_home is None.
    """

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        if hadoop_home:
            self._base = [os.path.join(hadoop_home, "bin", "hadoop"), "fs"]
        else:
            self._base = ["hadoop", "fs"]
        for k, v in (configs or {}).items():
            self._base += ["-D", f"{k}={v}"]
        self._time_out = time_out / 1000.0
        self._sleep_inter = sleep_inter / 1000.0

    # -- low-level --------------------------------------------------------
    def _run(self, *args, retries=3, check=True):
        last = None
        for attempt in range(retries):
            try:
                r = subprocess.run(
                    [*self._base, *args], capture_output=True, text=True,
                    timeout=self._time_out)
            except FileNotFoundError as e:
                raise ExecuteError(
                    f"hadoop binary not found ({self._base[0]}); install "
                    "hadoop or pass hadoop_home") from e
            except subprocess.TimeoutExpired as e:
                raise FSTimeOut(f"hadoop fs {' '.join(args)}") from e
            if r.returncode == 0 or not check:
                return r
            last = r
            time.sleep(self._sleep_inter)
        raise ExecuteError(
            f"hadoop fs {' '.join(args)} failed rc={last.returncode}: "
            f"{last.stderr.strip()[-500:]}")

    def _test(self, flag, path):
        return self._run("-test", flag, path, check=False).returncode == 0

    # -- FS interface -----------------------------------------------------
    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        out = self._run("-ls", path).stdout
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue  # "Found N items" header / malformed
            name = parts[-1].rstrip("/").rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_dir(self, path):
        return self._test("-d", path)

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def is_exist(self, path):
        return self._test("-e", path)

    def upload(self, local_path, fs_path):
        if not os.path.exists(local_path):
            raise FSFileNotExistsError(local_path)
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        self._run("-get", fs_path, local_path)

    def mkdirs(self, path):
        if not self.is_exist(path):
            self._run("-mkdir", "-p", path)

    def delete(self, path):
        if self.is_exist(path):
            self._run("-rm", "-r", path)

    def mv(self, src, dst, overwrite=False):
        if not overwrite and self.is_exist(dst):
            raise FSFileExistsError(dst)
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self._run("-mv", src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            if exist_ok:
                return
            raise FSFileExistsError(path)
        self._run("-touchz", path)

    def cat(self, path):
        if not self.is_exist(path):
            return ""
        return self._run("-cat", path).stdout

    def list_dirs(self, path):
        dirs, _ = self.ls_dir(path)
        return dirs

    def need_upload_download(self):
        return True
