"""Filesystem abstraction for fleet checkpoints (counterpart of
paddle_tpu/distributed/fleet/utils/fs.py; reference
python/paddle/distributed/fleet/utils/fs.py: the `FS` base, `LocalFS`,
and `HDFSClient`, which shells out to the hadoop CLI).

Checkpoints and dataset file lists take an FS object, so a job moves
between local disk and HDFS without code changes. HDFSClient needs the
`hadoop` binary on PATH (a CLI wrapper, as the reference's) and raises
a clear error otherwise. Standard library only.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Tuple

__all__ = ["FS", "LocalFS", "HDFSClient"]


class FS:
    def ls_dir(self, path) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def is_file(self, path) -> bool:
        raise NotImplementedError

    def is_dir(self, path) -> bool:
        raise NotImplementedError

    def is_exist(self, path) -> bool:
        raise NotImplementedError

    def mkdirs(self, path) -> None:
        raise NotImplementedError

    def delete(self, path) -> None:
        raise NotImplementedError

    def rename(self, src, dst) -> None:
        raise NotImplementedError

    def touch(self, path, exist_ok=True) -> None:
        raise NotImplementedError

    def upload(self, local_path, fs_path) -> None:
        raise NotImplementedError

    def download(self, fs_path, local_path) -> None:
        raise NotImplementedError

    def mv(self, src, dst, overwrite=False) -> None:
        self.rename(src, dst)


class LocalFS(FS):
    """Local-disk FS (reference LocalFS parity)."""

    def ls_dir(self, path):
        if not self.is_exist(path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(path)):
            (dirs if os.path.isdir(os.path.join(path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, path):
        return os.path.isfile(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_exist(self, path):
        return os.path.exists(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst):
        os.rename(src, dst)

    def mv(self, src, dst, overwrite=False):
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path, exist_ok=True):
        if os.path.exists(path):
            if not exist_ok:
                raise FileExistsError(path)
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        open(path, "a").close()

    def upload(self, local_path, fs_path):
        os.makedirs(os.path.dirname(fs_path) or ".", exist_ok=True)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def list_dirs(self, path):
        return self.ls_dir(path)[0]


class HDFSClient(FS):
    """`hadoop fs` CLI wrapper (reference HDFSClient parity). Needs the
    hadoop binary (configs["fs.default.name"] / ["hadoop.job.ugi"] are
    exported the same way the reference passes them)."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out: int = 300):
        self.hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                       if hadoop_home else "hadoop")
        self.configs = dict(configs or {})
        self.time_out = time_out
        if shutil.which(self.hadoop) is None:
            raise RuntimeError(
                f"HDFSClient needs the '{self.hadoop}' binary on PATH "
                "(it is a CLI wrapper, like the reference); use LocalFS "
                "for local checkpoints")

    def _run(self, *args, check=True) -> Tuple[int, str]:
        cmd = [self.hadoop, "fs"]
        for k, v in self.configs.items():
            cmd += ["-D", f"{k}={v}"]
        cmd += list(args)
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=self.time_out)
        if check and res.returncode != 0:
            raise RuntimeError(
                f"hadoop fs {' '.join(args)} failed: {res.stderr}")
        return res.returncode, res.stdout

    def ls_dir(self, path):
        _, out = self._run("-ls", path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return sorted(dirs), sorted(files)

    def is_exist(self, path):
        # same -D configs/timeout/capture as every other call; -test uses
        # its exit code as the answer, so no raise on nonzero
        rc, _ = self._run("-test", "-e", path, check=False)
        return rc == 0

    def is_dir(self, path):
        rc, _ = self._run("-test", "-d", path, check=False)
        return rc == 0

    def is_file(self, path):
        return self.is_exist(path) and not self.is_dir(path)

    def mkdirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def rename(self, src, dst):
        self._run("-mv", src, dst)

    def mv(self, src, dst, overwrite=False):
        if overwrite and self.is_exist(dst):
            self.delete(dst)
        self.rename(src, dst)

    def touch(self, path, exist_ok=True):
        if self.is_exist(path):
            # -touchz errors on non-empty files; the reference's touch is
            # a no-op for existing paths unless exist_ok is False
            if not exist_ok:
                raise FileExistsError(path)
            return
        self._run("-touchz", path)

    def upload(self, local_path, fs_path):
        self._run("-put", "-f", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)
