"""Error codes — byte-for-byte the reference's public error enum
(`Raytracer/Beam.h:8-16`).  API methods that return status codes in the
reference return the same codes here."""

ERROR_ALL_FINE = 0
ERROR_NO_VERTICES = 1
ERROR_INVALID_PARAMETER = 2
ERROR_GPU_ALLOC_FAIL = 3
ERROR_INVALID_FORMAT = 4
ERROR_RT_CAM_MISMATCH = 5
ERROR_UNLOCK_FIRST = 6
ERROR_LOCK_FIRST = 7
ERROR_NO_RENDER_TARGET = 8


class BeamError(RuntimeError):
    """Raised by APIs that prefer exceptions over status codes."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(f"error {code}: {message}")
        self.code = code
