"""DM-GAN's generator as a plain fp32 PyTorch reference for the tests.

Written from Zhu, Pan, Chen and Yang, "DM-GAN: Dynamic Memory Generative
Adversarial Networks for Text-to-Image Synthesis" (CVPR 2019,
arXiv:1904.01310), Sec. 3, and MinfengZhu/DM-GAN's ``code/model.py``
(``CA_NET``, ``INIT_STAGE_G``, ``NEXT_STAGE_G``, ``Memory``,
``GET_IMAGE_G``, ``G_NET``), step for step as that file computes it in
eval mode: its layouts (words (B, nef, L), images (B, C, H, W)), its
module and parameter names, its 1x1 Conv1d / Conv2d memory layers and
its BatchNorm1d / BatchNorm2d. Products run in true fp32: ``forward``
turns TF32 off for its call and restores the flags after.

It imports nothing of the port (nor JAX) and runs no kernel.

Departures from model.py:
- ``Memory`` masks each caption's row with its own mask. model.py's
  ``mask.repeat(queryL, 1)`` lays the batch's masks out row after row over
  the (batch * queryL) weight rows, so that a batch > 1 gives a row the
  mask of row ``(b * queryL + q) % batch``.
- ``CA_NET`` takes its eps as an argument (model.py draws it inside), so
  that a test can give both sides the same draw.
- ``G_NET.forward`` takes the mask as model.py's caller makes it (True at
  padding) and no ``cap_lens``, which it does not read; it returns the
  images, the attention maps, mu and logvar, as model.py does.
"""

import contextlib

import torch
import torch.nn as nn


@contextlib.contextmanager
def fp32():
    """True fp32 products (TF32 off) inside, the flags restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


class GLU(nn.Module):
    def forward(self, x):
        nc = x.size(1) // 2
        return x[:, :nc] * torch.sigmoid(x[:, nc:])


def conv3x3(in_planes, out_planes):
    return nn.Conv2d(in_planes, out_planes, 3, 1, 1, bias=False)


def upBlock(in_planes, out_planes):
    return nn.Sequential(nn.Upsample(scale_factor=2, mode="nearest"),
                         conv3x3(in_planes, out_planes * 2),
                         nn.BatchNorm2d(out_planes * 2), GLU())


class ResBlock(nn.Module):
    def __init__(self, channel_num):
        super().__init__()
        self.block = nn.Sequential(
            conv3x3(channel_num, channel_num * 2),
            nn.BatchNorm2d(channel_num * 2), GLU(),
            conv3x3(channel_num, channel_num),
            nn.BatchNorm2d(channel_num))

    def forward(self, x):
        return self.block(x) + x


class CA_NET(nn.Module):
    def __init__(self, t_dim, c_dim):
        super().__init__()
        self.c_dim = c_dim
        self.fc = nn.Linear(t_dim, c_dim * 4, bias=True)
        self.relu = GLU()

    def forward(self, text_embedding, eps):
        x = self.relu(self.fc(text_embedding))
        mu, logvar = x[:, :self.c_dim], x[:, self.c_dim:]
        return eps * logvar.mul(0.5).exp() + mu, mu, logvar


class INIT_STAGE_G(nn.Module):
    def __init__(self, ngf, ncf, nz):
        super().__init__()
        self.gf_dim = ngf
        self.fc = nn.Sequential(
            nn.Linear(nz + ncf, ngf * 4 * 4 * 2, bias=False),
            nn.BatchNorm1d(ngf * 4 * 4 * 2), GLU())
        self.upsample1 = upBlock(ngf, ngf // 2)
        self.upsample2 = upBlock(ngf // 2, ngf // 4)
        self.upsample3 = upBlock(ngf // 4, ngf // 8)
        self.upsample4 = upBlock(ngf // 8, ngf // 16)

    def forward(self, z_code, c_code):
        out_code = self.fc(torch.cat((c_code, z_code), 1))
        out_code = out_code.view(-1, self.gf_dim, 4, 4)
        out_code = self.upsample1(out_code)
        out_code = self.upsample2(out_code)
        out_code = self.upsample3(out_code)
        return self.upsample4(out_code)


class Memory(nn.Module):
    def __init__(self):
        super().__init__()
        self.mask = None

    def applyMask(self, mask):
        self.mask = mask                                   # batch x sourceL

    def forward(self, input, context_key, content_value):
        ih, iw = input.size(2), input.size(3)
        queryL = ih * iw
        batch_size, sourceL = context_key.size(0), context_key.size(2)
        target = input.view(batch_size, -1, queryL)
        targetT = torch.transpose(target, 1, 2).contiguous()
        weight = torch.bmm(targetT, context_key)    # batch x queryL x sourceL
        if self.mask is not None:                   # each row its own mask
            weight = weight.masked_fill(self.mask[:, None, :], -float("inf"))
        weight = torch.softmax(weight, dim=2)
        weight = torch.transpose(weight, 1, 2).contiguous()
        weightedContext = torch.bmm(content_value, weight)
        weightedContext = weightedContext.view(batch_size, -1, ih, iw)
        weight = weight.view(batch_size, -1, ih, iw)
        return weightedContext, weight


class NEXT_STAGE_G(nn.Module):
    def __init__(self, ngf, nef, size, r_num=2):
        super().__init__()
        self.gf_dim = ngf
        self.avg = nn.AvgPool2d(kernel_size=size)
        self.A = nn.Linear(nef, 1, bias=False)
        self.B = nn.Linear(ngf, 1, bias=False)
        self.M_r = nn.Sequential(nn.Conv1d(ngf, ngf * 2, 1, 1, 0), nn.ReLU())
        self.M_w = nn.Sequential(nn.Conv1d(nef, ngf * 2, 1, 1, 0), nn.ReLU())
        self.key = nn.Sequential(nn.Conv1d(ngf * 2, ngf, 1, 1, 0), nn.ReLU())
        self.value = nn.Sequential(nn.Conv1d(ngf * 2, ngf, 1, 1, 0),
                                   nn.ReLU())
        self.memory_operation = Memory()
        self.response_gate = nn.Sequential(nn.Conv2d(ngf * 2, 1, 1, 1, 0),
                                           nn.Sigmoid())
        self.residual = nn.Sequential(*[ResBlock(ngf * 2)
                                        for _ in range(r_num)])
        self.upsample = upBlock(ngf * 2, ngf)

    def forward(self, h_code, c_code, word_embs, mask):
        # memory writing
        word_embs_T = torch.transpose(word_embs, 1, 2).contiguous()
        h_code_avg = self.avg(h_code).detach()
        h_code_avg = h_code_avg.squeeze(3)
        h_code_avg_T = torch.transpose(h_code_avg, 1, 2).contiguous()
        gate1 = torch.transpose(self.A(word_embs_T), 1, 2).contiguous()
        gate2 = self.B(h_code_avg_T).repeat(1, 1, word_embs.size(2))
        writing_gate = torch.sigmoid(gate1 + gate2)
        h_code_avg = h_code_avg.repeat(1, 1, word_embs.size(2))
        memory = (self.M_w(word_embs) * writing_gate
                  + self.M_r(h_code_avg) * (1 - writing_gate))
        # key addressing and value reading
        key = self.key(memory)
        value = self.value(memory)
        self.memory_operation.applyMask(mask)
        memory_out, att = self.memory_operation(h_code, key, value)
        # key response
        response_gate = self.response_gate(torch.cat((h_code, memory_out), 1))
        h_code_new = h_code * (1 - response_gate) + response_gate * memory_out
        h_code_new = torch.cat((h_code_new, h_code_new), 1)
        out_code = self.residual(h_code_new)
        return self.upsample(out_code), att


class GET_IMAGE_G(nn.Module):
    def __init__(self, ngf):
        super().__init__()
        self.img = nn.Sequential(conv3x3(ngf, 3), nn.Tanh())

    def forward(self, h_code):
        return self.img(h_code)


class G_NET(nn.Module):
    """(z (B, nz), sentence (B, nef), words (B, nef, L), mask (B, L) True at
    padding, eps (B, ncf)) -> ([images (B, 3, R, R) in [-1, 1]], [attention
    (B, L, h, w)], mu, logvar)."""

    def __init__(self, ngf=64, nef=256, ncf=100, nz=100, branch_num=3):
        super().__init__()
        self.branch_num = branch_num
        self.ca_net = CA_NET(nef, ncf)
        self.h_net1 = INIT_STAGE_G(ngf * 16, ncf, nz)
        self.img_net1 = GET_IMAGE_G(ngf)
        if branch_num > 1:
            self.h_net2 = NEXT_STAGE_G(ngf, nef, 64)
            self.img_net2 = GET_IMAGE_G(ngf)
        if branch_num > 2:
            self.h_net3 = NEXT_STAGE_G(ngf, nef, 128)
            self.img_net3 = GET_IMAGE_G(ngf)

    def forward(self, z_code, sent_emb, word_embs, mask, eps):
        with fp32():
            c_code, mu, logvar = self.ca_net(sent_emb, eps)
            h_code = self.h_net1(z_code, c_code)
            fake_imgs, att_maps = [self.img_net1(h_code)], []
            for s in range(2, self.branch_num + 1):
                h_code, att = getattr(self, f"h_net{s}")(h_code, c_code,
                                                         word_embs, mask)
                fake_imgs.append(getattr(self, f"img_net{s}")(h_code))
                att_maps.append(att)
            return fake_imgs, att_maps, mu, logvar
