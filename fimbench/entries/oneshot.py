"""A fresh one-shot HPrepost mine a request, through the registered front
end (``get_miner("hprepost").mine``): no prep is cached between requests,
so every request pays its own rows copy, Job 1, Job 2 and F2."""


class OneShot:
    def __init__(self, n_items: int, device):
        from repro_torch.mining import get_miner

        self.n_items = n_items
        self.frontend = get_miner("hprepost", device=device)

    def __call__(self, rows, min_sup: float):
        from repro_torch.mining import MineSpec

        return self.frontend.mine(rows, self.n_items, MineSpec(algorithm="hprepost", min_sup=min_sup))


def build(rows, n_items: int, devices, config, traffic):
    del rows, config, traffic
    return OneShot(n_items, devices[0])
