"""Faults planted underneath a run, to show that the check catches them.

Each is ``plant(env, agent)``, applied to the program's objects before
set-up drives them; the run is otherwise the benchmark's own.

* ``unchanged``: a step that returns its state unchanged (``update_model``
  puts back the parameters and hands back the optimizer state it got);
* ``half_batch``: half of each minibatch left out, the mean taken over the
  rest (the losses see the first half of the rows);
* ``altered``: an answer altered where it is produced (each control
  step's joint velocities of env 0 written from env 1's, as an index off
  by one would).

The exchange between chips does not exist in a one-chip cell.
"""

from __future__ import annotations

from dataclasses import replace

import torch


def unchanged(env, agent):
    update = agent.update_model

    def update_model(ts, data, perms=None, generator=None):
        saved = [p.detach().clone() for p in ts.params.parameters()]
        _, info = update(ts, data, perms, generator)
        with torch.no_grad():
            for p, s in zip(ts.params.parameters(), saved):
                p.copy_(s)
        return ts, info

    agent.update_model = update_model


def half_batch(env, agent):
    loss = agent._loss
    agent._loss = lambda net, batch: loss(net, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


def altered(env, agent):
    step = env._step_fn

    def step_fn(params, sim, pd_target):
        sim, contact = step(params, sim, pd_target)
        dof_vel = sim.dof_vel.clone()
        dof_vel[0] = dof_vel[1]
        return replace(sim, dof_vel=dof_vel), contact

    env._step_fn = step_fn


FAULTS = dict(unchanged=unchanged, half_batch=half_batch, altered=altered)
