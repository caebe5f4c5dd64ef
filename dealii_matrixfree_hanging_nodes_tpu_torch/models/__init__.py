"""Operators of the index engine (``matrix_free.MatrixFree``)."""
