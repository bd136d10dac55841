"""SQLite persistence, bit-compatible with the reference schema.

The port's own copy of ``facekit.db.database``: same schema and the same
2048-byte float32 BLOBs, so either package reads a database the other
wrote.

Schema parity with ``src/db.cpp:39-65``:

    USER(USR_ID TEXT PRIMARY KEY, USR_NM TEXT)
    FACE(IMG_ID INTEGER PRIMARY KEY AUTOINCREMENT, USR_ID TEXT,
         IMG_PATH TEXT, EMBEDDING BLOB, UNIQUE(IMG_ID, USR_ID),
         FOREIGN KEY(USR_ID) REFERENCES USER(USR_ID))

EMBEDDING is the raw little-endian float32[dim] buffer exactly as the
reference binds it (``src/db.cpp:146``), so a database written by the C++
server loads here unchanged and vice versa.

Return-code conventions mirror the reference per method — the inserts
return 1 on success, the deletes return 0 on success (src/db.cpp:196,
232), negative = step/bind/prepare failure — so the HTTP layer can
reproduce its response strings. Known reference bug fixed here and documented: the C++
``deleteFace`` targets a nonexistent ``IMAGES_USER`` table
(``src/db.cpp:172``) and therefore silently never deletes; facekit deletes
from ``FACE`` (the table the schema actually creates).
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, List, Tuple

import numpy as np


class Database:
    def __init__(self, path: str, embedding_dim: int = 512):
        self.path = path
        self.embedding_dim = embedding_dim
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._create_tables()

    def _create_tables(self) -> None:
        with self._lock:
            cur = self._conn.cursor()
            cur.execute(
                "CREATE TABLE IF NOT EXISTS USER ("
                " USR_ID TEXT PRIMARY KEY,"
                " USR_NM TEXT)")
            cur.execute(
                "CREATE TABLE IF NOT EXISTS FACE ("
                " IMG_ID    INTEGER PRIMARY KEY AUTOINCREMENT,"
                " USR_ID    TEXT,"
                " IMG_PATH  TEXT,"
                " EMBEDDING BLOB,"
                " UNIQUE(IMG_ID, USR_ID),"
                " FOREIGN KEY(USR_ID) REFERENCES USER(USR_ID))")
            self._conn.commit()

    # -- mutations (reference src/db.cpp:83-261) ------------------------------

    def insert_user(self, user_id: str, user_name: str) -> int:
        """1 on success; -3 if the user already exists (PK violation),
        mirroring the reference's step-error return (src/db.cpp:109-119)."""
        try:
            with self._lock:
                self._conn.execute(
                    "INSERT INTO USER (USR_ID, USR_NM) VALUES (?, ?)",
                    (user_id, user_name))
                self._conn.commit()
            return 1
        except sqlite3.IntegrityError:
            return -3

    def insert_face(self, user_id: str, img_path: str,
                    embedding: np.ndarray) -> int:
        emb = np.ascontiguousarray(embedding, dtype="<f4")
        if emb.size != self.embedding_dim:
            return -2
        try:
            with self._lock:
                self._conn.execute(
                    "INSERT INTO FACE (USR_ID, IMG_PATH, EMBEDDING)"
                    " VALUES (?, ?, ?)",
                    (user_id, img_path, emb.tobytes()))
                self._conn.commit()
            return 1
        except sqlite3.Error:
            return -3

    def delete_face(self, img_id: int) -> int:
        with self._lock:
            self._conn.execute("DELETE FROM FACE WHERE IMG_ID=?", (img_id,))
            self._conn.commit()
        return 0

    def delete_user(self, user_id: str) -> int:
        with self._lock:
            self._conn.execute("DELETE FROM FACE WHERE USR_ID=?", (user_id,))
            self._conn.execute("DELETE FROM USER WHERE USR_ID=?", (user_id,))
            self._conn.commit()
        return 0

    # -- queries (reference src/db.cpp:263-346) --------------------------------

    def get_user_dict(self) -> Dict[str, str]:
        with self._lock:
            rows = self._conn.execute("SELECT * FROM USER").fetchall()
        return {r[0]: r[1] for r in rows}

    def get_embeddings(self) -> Tuple[List[str], np.ndarray]:
        """All gallery rows: (user_ids, (N, dim) float32 embeddings).

        The reference streams rows straight into the recognizer's host
        buffer (src/db.cpp:316-346 -> addEmbedding); facekit returns them
        for an atomic GalleryStore.load().
        """
        with self._lock:
            rows = self._conn.execute(
                "SELECT USR_ID, EMBEDDING FROM FACE").fetchall()
        names = [r[0] for r in rows]
        if rows:
            # bulk path: one join + one frombuffer (a python-loop stack is
            # ~10x slower at the 1M-row scale this store targets)
            blob = b"".join(r[1] for r in rows)
            embs = np.frombuffer(blob, dtype="<f4").reshape(
                len(rows), self.embedding_dim).copy()
        else:
            embs = np.zeros((0, self.embedding_dim), np.float32)
        return names, embs

    def close(self) -> None:
        with self._lock:
            self._conn.close()
