"""Minimal linear Kalman filter (predict/update), numpy.

A copy of ``terran_tpu/tracking/kalman.py``: the ~30 lines of linear
algebra SORT uses, with filterpy's defaults (identity P/Q/R) so that the
reference tracker's tuning factors apply unchanged. Host-side on purpose:
a 7-state filter over a handful of tracks has no business on the card.
"""

import numpy as np


class KalmanFilter:

    def __init__(self, dim_x, dim_z):
        self.dim_x = dim_x
        self.dim_z = dim_z
        self.x = np.zeros((dim_x, 1))
        self.P = np.eye(dim_x)
        self.Q = np.eye(dim_x)
        self.F = np.eye(dim_x)
        self.H = np.zeros((dim_z, dim_x))
        self.R = np.eye(dim_z)

    def predict(self):
        self.x = self.F @ self.x
        self.P = self.F @ self.P @ self.F.T + self.Q

    def update(self, z):
        z = np.asarray(z, dtype=float).reshape(self.dim_z, 1)
        y = z - self.H @ self.x
        s = self.H @ self.P @ self.H.T + self.R
        k = self.P @ self.H.T @ np.linalg.inv(s)
        self.x = self.x + k @ y
        identity = np.eye(self.dim_x)
        self.P = (identity - k @ self.H) @ self.P
