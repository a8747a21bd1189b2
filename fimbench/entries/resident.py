"""One ``MiningEngine`` holding the database's prep, built in set-up at the
configuration's threshold; every request is an ``engine.submit`` on the
same rows array, which the engine's fingerprint memo and cached
``PreparedDB`` serve without a prep."""


class Resident:
    def __init__(self, rows, n_items: int, device, floor: float):
        from repro_torch.mining import MineSpec, MiningEngine

        self.n_items = n_items
        self.engine = MiningEngine(device=device)
        self.engine.submit(rows, n_items, MineSpec(algorithm="hprepost", min_sup=floor))

    def __call__(self, rows, min_sup: float):
        from repro_torch.mining import MineSpec

        return self.engine.submit(rows, self.n_items, MineSpec(algorithm="hprepost", min_sup=min_sup))


def build(rows, n_items: int, devices, config, traffic):
    del traffic
    return Resident(rows, n_items, devices[0], config["min_sup"])
