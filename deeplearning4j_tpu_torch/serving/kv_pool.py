"""KVSlotPool — slot (and page) allocation over the batched decode
carries (port of `deeplearning4j_tpu/serving/kv_pool.py`).

The pool owns ONE carry tree built by `net.session_carries(slots)` on the
net's device: per attention layer either [slots, L, Hkv, Dh] caches, or
(paged mode) [pages, page_len, Hkv, Dh] page pools with per-slot page
tables, plus per-slot positions. A quantized pool (`kv_dtype` "int8" or
"fp8") holds int8 or e4m3 caches with float32 scale rows
[.., L, Hkv] beside them, which slot reset, page copy-on-write and the
accounting treat as part of the cache. A slot is the unit of admission; a page
is the unit of prefix sharing. Where the JAX pool ran small jitted
programs (reset, install, copy page, poison), the port runs in-place
tensor ops on the same tree under the pool lock; they are ordered with
the decode steps on the device's stream.

Against cross-session leakage the pool is belt-and-braces, as in JAX:
`free()` zeroes the slot's rows (its page table and position in paged
mode — shared pages stay), and the visibility arithmetic never shows a
fresh slot anything it did not write itself.

Hot-swap: `rebind(net)` points the pool at a deployed net whose carry
tree has the live one's layout (the same leaves, shapes and dtypes),
keeping the live carries, so sessions survive the flip; the caches keep
their addresses, so graphs captured over them stay valid. `reset(slot)`
zeroes a slot's rows without releasing it (the draft pool mirrors the
target pool's slots and is reset, not freed).

Not ported yet: fleet page export/import (ROADMAP A8, S5).
"""

from __future__ import annotations

import threading
from typing import Optional

import torch


class SlotPoolExhaustedError(RuntimeError):
    """No free KV slot or page (HTTP 503: admission is slots, not queue
    depth)."""


class IncompatibleSessionSwapError(RuntimeError):
    """A deploy candidate's session-carry tree (structure, shapes,
    dtypes) does not match the live pool's: live sessions cannot migrate
    onto it, so the deploy must roll back rather than drop them."""


def _leaves(tree, path=()):
    """(path, tensor) pairs of a nested carry dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def carry_layout(tree) -> list:
    """(path, shape, dtype) of every leaf of a carry tree, by path."""
    return sorted((path, tuple(a.shape), a.dtype)
                  for path, a in _leaves(tree))


class KVSlotPool:
    """Slot-indexed decode carries + free-list allocation + per-slot
    reset; in paged mode also a page free list with refcounts."""

    _CACHE_KEYS = ("cache_k", "cache_v", "scale_k", "scale_v")

    def __init__(self, net, slots: int, *, model: str = "default",
                 metrics=None, kv_dtype: Optional[str] = None,
                 page_len: Optional[int] = None,
                 pages: Optional[int] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.net = net
        self.slots = int(slots)
        self.model = model
        self.kv_dtype = kv_dtype or "native"
        self.page_len = int(page_len) if page_len else None
        self._cv = threading.Condition()
        if self.page_len:
            self.carries = net.session_carries(
                self.slots, kv_dtype=kv_dtype, page_len=self.page_len,
                pages=pages)
        else:
            self.carries = net.session_carries(self.slots,
                                               kv_dtype=kv_dtype)
        self._free = list(range(self.slots - 1, -1, -1))
        self._active = [False] * self.slots

        self.pages = self.npages = 0
        if self.page_len:
            for path, leaf in _leaves(self.carries):
                if path[-1] == "page_table":
                    self.npages = int(leaf.shape[1])
                elif path[-1] == "cache_k":
                    self.pages = int(leaf.shape[0])
            if not (self.pages and self.npages):
                raise ValueError("page_len set but the net produced no "
                                 "paged attention carries")
        self._page_free = list(range(self.pages - 1, -1, -1))
        self._page_ref = [0] * self.pages

        if metrics is None:
            from deeplearning4j_tpu_torch.observe import get_registry
            metrics = get_registry()
        self._g_total = metrics.gauge("serving_kv_slots", model=model)
        self._g_used = metrics.gauge("serving_kv_slots_in_use", model=model)
        self._c_allocs = metrics.counter("serving_kv_slot_allocs_total",
                                         model=model)
        self._c_resets = metrics.counter("serving_kv_slot_resets_total",
                                         model=model)
        self._g_total.set(self.slots)
        self._g_used.set(0)
        if self.page_len:
            self._g_pages = metrics.gauge("serving_kv_pages", model=model)
            self._g_pages_free = metrics.gauge("serving_kv_pages_free",
                                               model=model)
            self._g_pages.set(self.pages)
            self._g_pages_free.set(len(self._page_free))

    def lock(self):
        """The pool lock: the dispatch path holds it across read-carries
        -> step -> writeback, so dispatches serialize on the one tree."""
        return self._cv

    # ------------------------------------------------------- allocation
    def alloc(self, timeout_s: float = 0.0) -> int:
        """Claim a free slot; SlotPoolExhaustedError when none frees
        within `timeout_s`."""
        with self._cv:
            if not self._free and timeout_s > 0:
                self._cv.wait_for(lambda: bool(self._free), timeout_s)
            if not self._free:
                raise SlotPoolExhaustedError(
                    f"all {self.slots} KV slots in use")
            slot = self._free.pop()
            self._active[slot] = True
            self._c_allocs.inc()
            self._g_used.set(self.slots - len(self._free))
            return slot

    def _reset_locked(self, slot: int) -> None:
        """Zero the slot's rows of every slot-indexed leaf. Paged cache
        leaves are page-indexed and may hold pages other sessions still
        read, so only the slot's view (page table, position) is reset."""
        for path, a in _leaves(self.carries):
            if a.ndim < 1 or a.shape[0] != self.slots:
                continue
            if self.page_len and path[-1] in self._CACHE_KEYS:
                continue
            a[slot].zero_()
        self._c_resets.inc()

    def reset(self, slot: int) -> None:
        """Zero a slot's rows without releasing it."""
        with self._cv:
            self._reset_locked(slot)

    def free(self, slot: int) -> None:
        """Zero the slot's carry rows and return it to the free list.
        Idempotent."""
        with self._cv:
            self.free_locked(slot)

    def free_locked(self, slot: int) -> None:
        """`free` for a caller that holds `lock()`, so that a session's
        teardown releases its pages and its slot in one critical section."""
        if not self._active[slot]:
            return
        self._reset_locked(slot)
        self._active[slot] = False
        self._free.append(slot)
        self._g_used.set(self.slots - len(self._free))
        self._cv.notify_all()

    # ------------------------------------------------------ paged mode
    # `*_locked` methods: the caller holds `lock()` for the whole
    # admission / teardown sequence (the Condition is not reentrant).

    def pages_free_locked(self) -> int:
        return len(self._page_free)

    def page_refcount_locked(self, page: int) -> int:
        return self._page_ref[page]

    def page_alloc_locked(self, n: int) -> list:
        """Claim `n` fresh physical pages (refcount 1 each)."""
        if n > len(self._page_free):
            raise SlotPoolExhaustedError(
                f"need {n} KV pages, {len(self._page_free)} free "
                f"(of {self.pages})")
        out = [self._page_free.pop() for _ in range(n)]
        for p in out:
            self._page_ref[p] = 1
        self._g_pages_free.set(len(self._page_free))
        return out

    def page_ref_locked(self, page: int) -> int:
        """Take a reference on a live page."""
        if self._page_ref[page] <= 0:
            raise ValueError(f"page {page} is not live")
        self._page_ref[page] += 1
        return self._page_ref[page]

    def page_unref_locked(self, page: int) -> int:
        """Drop a reference; the page returns to the free list at zero.
        Freed pages are not zeroed: position arithmetic keeps their old
        contents invisible."""
        if self._page_ref[page] <= 0:
            raise ValueError(f"page {page} is not live")
        self._page_ref[page] -= 1
        if self._page_ref[page] == 0:
            self._page_free.append(page)
            self._g_pages_free.set(len(self._page_free))
            self._cv.notify_all()
        return self._page_ref[page]

    def install_pages_locked(self, slot: int, pages: list,
                             pos: int) -> None:
        """Point `slot`'s page table at `pages` (padded with physical page
        0, a valid index the kernels' visibility never reads) and set its
        decode position, in every layer."""
        row = torch.tensor(list(pages) + [0] * (self.npages - len(pages)),
                           dtype=torch.int32)
        for path, a in _leaves(self.carries):
            if path[-1] == "page_table":
                a[slot].copy_(row)
            elif path[-1] == "pos":
                a[slot] = int(pos)

    def copy_page_locked(self, src: int, dst: int) -> None:
        """Copy one physical page's K/V (and scale rows): the
        copy-on-write fork."""
        for path, a in _leaves(self.carries):
            if path[-1] in self._CACHE_KEYS:
                a[dst].copy_(a[src])

    # ------------------------------------------------------- step seam
    def swap_carries(self, new_carries) -> None:
        """Install the post-step carry tree (callers hold `lock()`)."""
        self.carries = new_carries

    # -------------------------------------------------------- hot swap
    def candidate_layout(self, net, kv_dtype: Optional[str] = None) -> list:
        """The carry layout `net` would build for this pool (its slots,
        pages and KV dtype), made on the meta device: no memory."""
        kd = self.kv_dtype if kv_dtype is None else kv_dtype
        kd = None if kd == "native" else kd
        if self.page_len:
            tree = net.session_carries(self.slots, kv_dtype=kd,
                                       page_len=self.page_len,
                                       pages=self.pages, device="meta")
        else:
            tree = net.session_carries(self.slots, kv_dtype=kd,
                                       device="meta")
        return carry_layout(tree)

    def rebind(self, net, kv_dtype: Optional[str] = None) -> None:
        """Point the pool at a hot-swapped net, keeping the live carries
        (sessions survive the flip). The candidate must build a carry
        tree of the live one's layout, KV dtype included (live int8
        caches cannot migrate onto a native tree, nor the other way);
        otherwise IncompatibleSessionSwapError."""
        want = self.candidate_layout(net, kv_dtype)
        with self._cv:
            have = carry_layout(self.carries)
            if want != have:
                diff = next((w, h) for w, h in zip(want + [None],
                                                   have + [None])
                            if w != h)
                raise IncompatibleSessionSwapError(
                    f"session carries of the deploy candidate do not "
                    f"match the live pool (candidate, live: {diff}); "
                    f"live sessions cannot migrate")
            self.net = net

    # ------------------------------------------------------ inspection
    def _slot_bytes(self) -> tuple:
        """(actual, native) bytes a slot across the carry tree: the
        caches at their stored width against the net dtype's, the scale
        rows against nothing, every other leaf the same on both sides.
        native / actual is the slots-per-card multiplier quantization
        buys at a fixed carry budget."""
        dtype = getattr(self.net, "dtype", torch.float32)
        native_size = torch.tensor([], dtype=dtype).element_size()
        actual = native = 0
        for path, a in _leaves(self.carries):
            nbytes = a.numel() * a.element_size()
            actual += nbytes
            if path[-1] in ("cache_k", "cache_v"):
                native += a.numel() * native_size
            elif path[-1] not in ("scale_k", "scale_v"):
                native += nbytes
        return actual / self.slots, native / self.slots

    def describe(self) -> dict:
        with self._cv:
            actual, native = self._slot_bytes()
            out = {"total": self.slots,
                   "in_use": self.slots - len(self._free),
                   "model": self.model,
                   "kv_dtype": self.kv_dtype,
                   "slot_bytes": int(actual),
                   "slots_per_chip_factor": round(native / actual, 2)
                   if actual else 1.0}
            if self.page_len:
                out["page_len"] = self.page_len
                out["pages"] = self.pages
                out["pages_free"] = len(self._page_free)
            return out
