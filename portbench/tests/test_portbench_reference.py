"""The plain reference against the port at toy size on the CPU, and the
comparison with the timed path broken underneath: each fault a cell can
have must come out not correct. These drive the rest of a run (set-up,
window, release, the reference and its limits) without the harness's look
for a card."""

from portbench.drivers import fit
from portbench.tests import toy


def test_fit_reference_agrees_with_the_port(tmp_path):
    res, checks = toy.run_cell(fit, toy.fit_ctx(tmp=tmp_path))
    assert res['images'] >= 1 and res['steps'][0] == 4
    assert toy.correct(checks), checks


def test_fit_loss_altered_is_caught(tmp_path, monkeypatch):
    from tuch_tpu_torch.fitting import eft
    loss = eft.eft_loss

    def altered(*args, **kwargs):
        total, parts = loss(*args, **kwargs)
        return total * 1.01, parts
    monkeypatch.setattr(eft, 'eft_loss', altered)
    _, checks = toy.run_cell(fit, toy.fit_ctx(tmp=tmp_path))
    assert not toy.correct(checks), checks


def test_fit_stop_rule_changed_is_caught(tmp_path, monkeypatch):
    from tuch_tpu_torch.fitting import eft
    make = eft.make_eft_fit_fn

    def one_step_less(*args, **kwargs):
        kwargs['max_steps'] -= 1
        return make(*args, **kwargs)
    monkeypatch.setattr(eft, 'make_eft_fit_fn', one_step_less)
    _, checks = toy.run_cell(fit, toy.fit_ctx(tmp=tmp_path))
    by = {c['name']: c for c in checks}
    assert by['steps_gap']['value'] == 1.0
    assert not toy.correct(checks)


def test_fit_state_left_unchanged_is_caught(tmp_path, monkeypatch):
    from tuch_tpu_torch.fitting import eft

    class Frozen(eft.Adam):
        def step(self, params, grads):
            return dict(params)
    monkeypatch.setattr(eft, 'Adam', Frozen)
    _, checks = toy.run_cell(fit, toy.fit_ctx(tmp=tmp_path))
    assert not toy.correct(checks), checks
