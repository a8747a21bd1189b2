"""A sliding-window click stream: one ``MiningEngine`` stream that holds
the last ``window_batches`` batches, its floor the configuration's
``min_sup``. Set-up cuts the rows in order into ``window_batches`` batches
(``np.array_split``) and appends them; each request appends the next batch
in cyclic order, whose append expires the oldest — a batch of the same
rows — so that the window always holds exactly the generated rows, and
then mines the window with ``engine.submit_stream``."""
import numpy as np

STREAM = "clicks"


class Window:
    def __init__(self, rows, n_items: int, device, config):
        from repro_torch.mining import MiningEngine
        from repro_torch.mining.stream import StreamSpec

        n_batches = config["stream"]["window_batches"]
        self.n_items = n_items
        self.batches = np.array_split(rows, n_batches)
        self.engine = MiningEngine(device=device)
        spec = StreamSpec(window_batches=n_batches, min_sup_floor=config["min_sup"])
        for batch in self.batches:
            self.engine.append(batch, n_items, stream=STREAM, stream_spec=spec)
        self.next = 0

    def __call__(self, rows, min_sup: float):
        from repro_torch.mining import MineSpec

        del rows  # the window holds them
        self.engine.append(self.batches[self.next], stream=STREAM)
        self.next = (self.next + 1) % len(self.batches)
        return self.engine.submit_stream(MineSpec(algorithm="hprepost", min_sup=min_sup),
                                         stream=STREAM)


def build(rows, n_items: int, devices, config, traffic):
    del traffic
    return Window(rows, n_items, devices[0], config)
