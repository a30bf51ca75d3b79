"""Fixture: draws from torch's global generator, each marked, and the
``generator=`` forms that must NOT fire."""
import torch


def seeders(seed):
    torch.manual_seed(seed)  # VIOLATION: seeds the global generator
    torch.seed()  # VIOLATION
    torch.cuda.manual_seed(seed)  # VIOLATION
    torch.cuda.manual_seed_all(seed)  # VIOLATION


def factories(n, p, x):
    return (torch.rand(n),  # VIOLATION
            torch.randn(n, 2),  # VIOLATION
            torch.randint(0, 5, (n,)),  # VIOLATION
            torch.randperm(n),  # VIOLATION
            torch.normal(x, 1.0),  # VIOLATION
            torch.bernoulli(p),  # VIOLATION
            torch.multinomial(p, 1),  # VIOLATION
            torch.poisson(p),  # VIOLATION
            torch.rand_like(x),  # VIOLATION
            torch.randn_like(x))  # VIOLATION


def in_place(x):
    x.uniform_()  # VIOLATION
    x.normal_(0.0, 1.0)  # VIOLATION
    x.random_(0, 5)  # VIOLATION
    x.exponential_()  # VIOLATION
    x.bernoulli_(0.5)  # VIOLATION
    x.cauchy_()  # VIOLATION
    x.log_normal_()  # VIOLATION
    x.geometric_(0.5)  # VIOLATION
    torch.nn.init.normal_(x)  # VIOLATION
    return x


def seeded_ok(seed, n, p, x):
    gen = torch.Generator().manual_seed(seed)
    x.uniform_(generator=gen)
    x.normal_(0.0, 1.0, generator=gen)
    torch.nn.init.normal_(x, generator=gen)
    return (torch.rand(n, generator=gen), torch.randn(n, generator=gen),
            torch.randint(0, 5, (n,), generator=gen),
            torch.randperm(n, generator=gen),
            torch.multinomial(p, 1, generator=gen),
            torch.bernoulli(p, generator=gen), torch.ones_like(x))
