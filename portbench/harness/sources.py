"""A live camera for the benchmark: yields frame ``i`` of its pool at
``start + offset + i / rate`` and not before, and records when each frame
was taken. Frames the consumer asks for late are handed over at once, so
a consumer that falls behind builds a backlog of due frames and never
drops one: the load is offered on the camera's schedule (an open loop)."""

import time


class EndOfStream(Exception):
    """Raised after the last frame due before ``end``."""


class PacedSource:
    """``read_frames()`` in the ``Video`` protocol of the program's
    multiplexer; ``framerate`` as a video states it."""

    def __init__(self, pool, rate, offset, end_error=EndOfStream,
                 clock=time.perf_counter, sleep=time.sleep):
        self.pool, self.framerate = pool, rate
        self.offset = offset
        self.start = self.end = None
        self.end_error = end_error
        self.clock, self.sleep = clock, sleep
        self.taken = []  # perf_counter time each frame was handed over

    def schedule(self, start, end):
        """Frame 0 is due at ``start + offset``; the last frame is the
        last one due before ``end``."""
        self.start, self.end = start, end

    def due(self, i):
        return self.start + self.offset + i / self.framerate

    def read_frames(self):
        i = len(self.taken)
        due = self.due(i)
        if due >= self.end:
            raise self.end_error()
        wait = due - self.clock()
        if wait > 0:
            self.sleep(wait)
        self.taken.append(self.clock())
        return self.pool[i % len(self.pool)]

    def lateness(self):
        """Seconds each frame was handed over after it was due."""
        return [t - self.due(i) for i, t in enumerate(self.taken)]
